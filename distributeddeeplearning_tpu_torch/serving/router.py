"""Multi-replica serving router: the fleet front door over N engines.

A single :class:`~.engine.ServingEngine` is one card's worth of serving —
one queue, ``slots`` decode lanes, one program set. The
:class:`ReplicaRouter` multiplies it: N identical engine replicas
(in-process, sharing the model's weights and the device; or, over
sockets, one worker process each — ``serving/worker.py``) behind one
admission tier. Three concerns live here and ONLY here — the
engines stay completely unaware of each other:

- **Dispatch** (``serving.router_policy``): ``least_loaded`` pulls every
  live replica's ``scheduler.gauges()`` at EVERY dispatch — queue depth,
  busy lanes, pool occupancy are host-side integers, so reading them per
  tick costs nothing and the router never acts on a stale
  ``gauge_every``-cadence snapshot. ``round_robin`` rotates blindly (the
  baseline the gauges have to beat). ``prefix_affinity`` (requires
  ``serving.prefix_cache``) additionally probes each live replica's
  prefix-trie digest (``engine.prefix_match_len`` — a read-only hash
  walk, no refcount or LRU effect) and sends the request where the most
  prompt KV is already cached: cached tokens are prefill compute the
  replica never spends, which usually beats a small queue-depth edge
  elsewhere. Ties break on the least-loaded key, and a STARVATION GUARD
  caps the bet: when the affinity target's queue is already more than
  one lane-batch (``slots``) deeper than the idlest replica's, the
  request falls back to least-loaded — affinity concentrates warm
  prefixes, it never wedges a replica while others idle. The router
  itself holds NO affinity state (no prefix->replica map to invalidate):
  the trie IS the state, it lives replica-side, and it dies with a
  quarantined replica — re-routed requests simply probe the survivors.

- **SLO-aware admission** (``serving.shed_policy='deadline'``): a request
  carrying ``deadline_s`` is checked for feasibility AT THE FRONT DOOR —
  estimated queue wait + prefill on the chosen replica (that replica's
  ``queue_wait``/``prefill`` latency-histogram percentiles, floored by
  its live ``oldest_queued_age_s`` gauge, which leads the histograms
  during a wedge) against the deadline. An infeasible request is shed
  immediately: a typed ``request_shed`` event plus a typed
  :class:`RequestShed` raise, and the request NEVER consumes a prefill
  or a queue slot. Admitting it instead would rot in a queue, get
  deadline-dropped engine-side anyway, and meanwhile push every request
  behind it past ITS deadline — shedding is what keeps goodput from
  collapsing under overload.

- **Elastic membership**: :meth:`drain` cuts one replica's intake
  (in-flight and queued work completes token-identically, new
  submissions route elsewhere) for graceful scale-down; a replica whose
  ``step()`` RAISES is quarantined — its queued, never-admitted requests
  re-route to surviving replicas (typed ``request_rerouted``), its
  in-flight requests are reported lost (typed ``request_failed``; their
  KV state died with the replica).

Determinism: the router assigns globally-unique request ids and every
replica runs the same weights and seed, so a request's greedy tokens are
IDENTICAL whichever replica serves it — and identical to a direct
single-engine run (pinned in tests/test_torch_serving_router.py against
the JAX package's router, and on the card by ``chip_smoke.py``).

Telemetry: each replica gets its own stamped bundle
(``process_index=i``) in one shared dir, the layout N training processes
write.
"""

from __future__ import annotations

import copy
import dataclasses
import select
import time

from ..metrics import event_record, serving_event
from ..telemetry import NULL_TELEMETRY, Telemetry
from .engine import ROUTER_POLICIES, SHED_POLICIES, ServingEngine
from . import net
from .scheduler import Request, RequestState, chain_digests


class RequestShed(RuntimeError):
    """Typed admission rejection: the request's deadline is infeasible on
    the least-loaded live replica, so the router refused it before it
    consumed anything. ``record`` is the emitted ``request_shed`` event
    (replica index, deadline, the estimate that condemned it)."""

    def __init__(self, message: str, record: dict):
        super().__init__(message)
        self.record = record


class StaleHeartbeat(RuntimeError):
    """A socket replica missed ``serving.heartbeat_timeout_s`` of
    heartbeats — the router quarantines it exactly like a step fault."""


@dataclasses.dataclass
class Replica:
    """One engine behind the router, plus its membership state.

    This class doubles as the router's TRANSPORT INTERFACE: every method
    below is what the dispatch / shed / drain / quarantine code paths
    call, and :class:`SocketReplica` implements the same surface over a
    worker process's socket — the policy logic never forks on transport.
    """

    index: int
    engine: ServingEngine
    telemetry: Telemetry
    draining: bool = False
    quarantined: bool = False
    error: str | None = None

    @property
    def live(self) -> bool:
        """Eligible for NEW work (still stepped while draining)."""
        return not (self.draining or self.quarantined)

    # -- transport surface (duck-typed; SocketReplica mirrors it) --------

    #: In-process probes are live, so heartbeat staleness never applies.
    heartbeat_expected = False
    last_heartbeat_s = 0.0

    @property
    def role(self) -> str:
        """Phase pin (serving.role): 'unified' serves end-to-end,
        'prefill' hands finished chains off, 'decode' adopts them."""
        return getattr(self.engine, "role", "unified")

    @property
    def block_size(self) -> int:
        return self.engine.block_size

    @property
    def slots_n(self) -> int:
        return self.engine.slots_n

    @property
    def num_compiles(self) -> int:
        return self.engine.num_compiles

    @property
    def engine_idle(self) -> bool:
        # A queued-but-untaken handoff is in-flight fleet work: the
        # router must not read idle before dispatching it.
        return (self.engine.scheduler.idle
                and not self.engine.scheduler.handoff_queue_depth)

    def load_gauges(self, now: float) -> dict:
        """Dispatch-time load signals — pulled FRESH from the scheduler
        (the in-process luxury the socket transport approximates with
        pushed heartbeats + its own submit ledger)."""
        return self.engine.scheduler.gauges(now)

    def match_digests(self, digests: list[bytes]) -> int:
        return self.engine.prefix_match_digests(digests)

    def estimate_parts(self, now: float,
                       percentile: float) -> tuple[float, float, int]:
        """(queue_wait_floor, prefill_estimate, pending) for the shed
        feasibility formula in ``ReplicaRouter._admit_estimate``."""
        g = self.engine.scheduler.gauges(now)
        hists = self.telemetry.hists

        def pct(name: str) -> float:
            h = hists.get(name)
            if h is None or not h.count:
                return 0.0
            return h.percentile(percentile) or 0.0

        queue_wait = max(
            pct("queue_wait"), float(g.get("oldest_queued_age_s") or 0.0)
        )
        return queue_wait, pct("prefill"), g["pending"]

    def submit_request(self, request: Request, arrival_s: float,
                       epoch: int = 0) -> RequestState:
        # ``epoch`` is the request's attempt number (router-side retry
        # ledger). In-process engines deliver results synchronously —
        # there is no late frame to discard — so it is accepted for
        # surface parity and ignored.
        return self.engine.submit(request, arrival_s)

    def reroute_in(self, request: Request, arrival_s: float,
                   epoch: int = 0) -> None:
        # Straight into the scheduler, bypassing the draining check the
        # front door applies: rerouted work was ALREADY accepted.
        self.engine.scheduler.submit(request, arrival_s)

    def step(self) -> bool:
        return self.engine.step()

    def take_handoffs(self) -> list[dict]:
        """Drain the engine's pending prefill→decode handoffs into the
        router's normalized record shape (the socket transport produces
        the same shape from KV frames, so routing never forks)."""
        out = []
        for h in self.engine.take_handoffs():
            out.append({
                "request": h["request"],
                "arrival_s": h["state"].arrival_s,
                "epoch": None,  # router fills from its own ledger
                "digests": list(h["digests"]),
                "payloads": list(h["payloads"]),
                "offset": 0,
                "part": 0,
                "last": True,
            })
        return out

    def adopt_handoff(self, rec: dict) -> None:
        """Deliver a handed-off chain: graft the blocks (best-effort —
        a failed adoption just cold-prefills) and, on the chain's last
        part, enqueue the request past the draining front door (it was
        accepted fleet-wide on the prefill side)."""
        try:
            self.engine.adopt_chain(
                list(rec["request"].prompt), rec["payloads"],
                offset=rec["offset"],
            )
        except ValueError:
            self.engine.handoff_stats["adopt_fallbacks"] += 1
        if rec["last"]:
            self.engine.scheduler.submit(rec["request"], rec["arrival_s"])

    def start_drain(self) -> None:
        self.engine.drain()

    def take_queued(self) -> list[tuple[Request, float]]:
        """Pop every queued (never-admitted) request for rerouting."""
        sched = self.engine.scheduler
        queued = [(st.request, st.arrival_s) for st in sched.pending]
        sched.pending.clear()
        return queued

    def lost_inflight(self) -> list[RequestState]:
        """Mark in-flight requests lost (their KV died with the replica)
        and return their states."""
        out = []
        for state in self.engine.scheduler.active:
            state.dropped = True
            out.append(state)
        return out

    def finished_states(self) -> list[RequestState]:
        return self.engine.scheduler.finished

    def stats_snapshot(self) -> dict:
        return self.engine.stats()

    def do_warmup(self) -> None:
        self.engine.warmup()

    def set_engine_clock(self, clock) -> None:
        self.engine.clock = clock

    def close(self) -> None:
        pass


class SocketReplica:
    """One fleet worker process behind the router, spoken to over the
    length-prefixed-JSON protocol (serving/net.py). Same transport
    surface as :class:`Replica`; the differences are WHERE state lives:

    - load gauges come from the worker's last pushed heartbeat, overlaid
      with this side's own submit ledger (``pending``/``active`` derived
      from submit/admitted/result frames, which are fresher than any
      heartbeat cadence);
    - the prefix probe walks the heartbeat's digest-summary SET — zero
      cross-process round trips on the submit path;
    - ``step()`` pumps the socket instead of stepping an engine (the
      worker steps itself, on its own core — that is the whole point).

    Any socket/protocol fault raises out of ``step()`` and the shared
    quarantine path handles it like an engine fault.
    """

    heartbeat_expected = True

    def __init__(self, index: int, sock, hello: dict, *,
                 clock=time.monotonic, telemetry=NULL_TELEMETRY,
                 decoder=None, backlog=()):
        self.index = int(index)
        self.sock = sock
        self.telemetry = telemetry
        self.draining = False
        self.quarantined = False
        self.error: str | None = None
        self.engine = None  # no in-process engine behind this handle
        self._clock = clock
        # The handshake's decoder carries over so bytes read past the
        # hello frame are not lost.
        self._decoder = decoder if decoder is not None else (
            net.FrameDecoder()
        )
        self.hello = dict(hello)
        self.role = str(hello.get("role", "unified"))
        self.block_size = int(hello["block_size"])
        self.slots_n = int(hello["slots"])
        self.num_compiles = int(hello.get("num_compiles", 0))
        self.worker_pid = hello.get("pid")
        # Pushed state (heartbeats).
        self.last_heartbeat_s = clock()
        self.heartbeat_seq = -1
        self.hb_gauges: dict = {}
        self.hb_stats: dict = {}
        self._digests: frozenset[bytes] = frozenset()
        self._est_queue_wait_s = 0.0
        self._est_prefill_s = 0.0
        # Submit ledger: request_id -> (Request, arrival_s, epoch). A
        # request leaves ``_queued`` on the worker's ``admitted`` frame
        # and the whole ledger on its ``result`` frame. ``epoch`` is the
        # attempt number the router submitted under — a late frame from
        # a half-dead worker carries the OLD epoch and is discarded
        # (``stale_frames``), never double-delivered.
        self._outstanding: dict[int, tuple[Request, float, int]] = {}
        self._queued: set[int] = set()
        self._results: dict[int, RequestState] = {}
        self._stream: dict[int, list[int]] = {}
        #: Discarded admitted/result frames: unknown request id, epoch
        #: mismatch, or a duplicate of an already-recorded result.
        self.stale_frames = 0
        #: Inbound binary KV frames (prefill→decode handoffs) awaiting
        #: the router's dispatch pass.
        self._kv_frames: list[net.KVFrame] = []
        #: Out-of-order heartbeats dropped by the seq check.
        self.stale_heartbeats = 0
        self.goodbye: dict | None = None
        for msg in backlog:
            # Frames the handshake read past the hello (e.g. the first
            # heartbeat) fold in before any dispatch.
            self._handle(msg)

    @property
    def live(self) -> bool:
        return not (self.draining or self.quarantined)

    @property
    def engine_idle(self) -> bool:
        return not self._outstanding

    def load_gauges(self, now: float) -> dict:
        """Heartbeat gauges overlaid with the submit ledger: queue depth
        and busy lanes the router can compute EXACTLY from its own
        submit/admitted/result frames (no heartbeat staleness on the
        signals that matter most), pool occupancy at heartbeat cadence
        (only the worker knows its block pool)."""
        g = dict(self.hb_gauges)
        g["pending"] = len(self._queued)
        g["active"] = min(
            len(self._outstanding) - len(self._queued), self.slots_n
        )
        g.setdefault("free_blocks", 0)
        g.setdefault("used_blocks", 0)
        if self._queued:
            oldest = min(
                self._outstanding[rid][1] for rid in self._queued
            )
            g["oldest_queued_age_s"] = max(0.0, now - oldest)
        else:
            g["oldest_queued_age_s"] = 0.0
        return g

    def match_digests(self, digests: list[bytes]) -> int:
        """Leading-run membership in the pushed digest summary. A chain
        digest names its whole prefix, so a flat set reproduces the
        worker trie's ``match_digests`` (modulo heartbeat staleness)."""
        n = 0
        for d in digests:
            if d not in self._digests:
                break
            n += 1
        return n * self.block_size

    def estimate_parts(self, now: float,
                       percentile: float) -> tuple[float, float, int]:
        g = self.load_gauges(now)
        queue_wait = max(
            self._est_queue_wait_s,
            float(g.get("oldest_queued_age_s") or 0.0),
        )
        return queue_wait, self._est_prefill_s, g["pending"]

    def submit_request(self, request: Request, arrival_s: float,
                       epoch: int = 0) -> RequestState:
        rid = int(request.request_id)
        net.send_frame(self.sock, {
            "op": "submit",
            "arrival_s": arrival_s,
            "epoch": int(epoch),
            "request": _request_to_wire(request),
        })
        self._outstanding[rid] = (request, arrival_s, int(epoch))
        self._queued.add(rid)
        # Placeholder state (the authoritative one lives worker-side and
        # comes back in the result frame).
        return RequestState(request=request, arrival_s=arrival_s)

    def reroute_in(self, request: Request, arrival_s: float,
                   epoch: int = 0) -> None:
        # ``reroute`` makes the worker bypass its engine's draining
        # front door (scheduler.submit, same as the in-process
        # Replica.reroute_in): displaced work was ALREADY accepted.
        rid = int(request.request_id)
        net.send_frame(self.sock, {
            "op": "submit",
            "arrival_s": arrival_s,
            "epoch": int(epoch),
            "reroute": True,
            "request": _request_to_wire(request),
        })
        self._outstanding[rid] = (request, arrival_s, int(epoch))
        self._queued.add(rid)

    def step(self) -> bool:
        """Pump the socket: drain readable frames, fold pushed state in.
        Raises on EOF/protocol fault → shared quarantine path."""
        frames = net.recv_available(self.sock, self._decoder)
        if frames is None:
            if self._outstanding:
                raise net.ProtocolError(
                    f"worker {self.index} closed its socket with "
                    f"{len(self._outstanding)} requests outstanding"
                )
            return False
        for msg in frames:
            self._handle(msg)
        return bool(self._outstanding)

    def _frame_epoch_ok(self, msg: dict) -> "tuple[int, bool]":
        """(request_id, accept?) for an admitted/result frame: the frame
        must name a ledgered request AND carry the epoch the router
        submitted it under. A late frame from a previous attempt (the
        half-dead-worker case) or for an already-resolved request is
        discarded with ``stale_frames`` incremented — at-most-once
        delivery lives or dies on this check."""
        rid = int(msg["request_id"])
        entry = self._outstanding.get(rid)
        if entry is None or int(msg.get("epoch", 0)) != entry[2]:
            self.stale_frames += 1
            return rid, False
        return rid, True

    def _handle(self, msg) -> None:
        if isinstance(msg, net.KVFrame):
            # Prefill worker shipping a finished chain: park it for the
            # router's handoff-dispatch pass (this class is transport,
            # placement policy lives router-side).
            self._kv_frames.append(msg)
            return
        kind = msg.get("type")
        if kind == "heartbeat":
            seq = int(msg.get("seq", -1))
            if seq <= self.heartbeat_seq:
                # Out-of-order delivery (or a replayed frame): fresher
                # gauges are already folded in — letting an older
                # heartbeat through would roll load signals BACK and
                # reset the staleness clock of a worker that re-stalled.
                self.stale_heartbeats += 1
                return
            self.last_heartbeat_s = self._clock()
            self.heartbeat_seq = seq
            self.hb_gauges = dict(msg.get("gauges") or {})
            self.hb_stats = dict(msg.get("stats") or {})
            self.num_compiles = int(
                msg.get("num_compiles", self.num_compiles)
            )
            self._digests = frozenset(
                net.digests_from_wire(msg.get("digests") or [])
            )
            self._est_queue_wait_s = float(msg.get("est_queue_wait_s", 0.0))
            self._est_prefill_s = float(msg.get("est_prefill_s", 0.0))
            net.send_frame(self.sock, {
                "op": "heartbeat_ack", "seq": self.heartbeat_seq,
            })
        elif kind == "admitted":
            rid, ok = self._frame_epoch_ok(msg)
            if ok:
                self._queued.discard(rid)
        elif kind == "token_delta":
            self._stream.setdefault(
                int(msg["request_id"]), []
            ).extend(int(t) for t in msg.get("tokens", ()))
        elif kind == "result":
            rid, ok = self._frame_epoch_ok(msg)
            if not ok:
                return
            entry = self._outstanding.pop(rid)
            self._queued.discard(rid)
            self._results[rid] = _state_from_wire(
                entry[0], msg["state"]
            )
        elif kind == "submit_error":
            rid = int(msg["request_id"])
            self._outstanding.pop(rid, None)
            self._queued.discard(rid)
            raise net.ProtocolError(
                f"worker {self.index} rejected request {rid}: "
                f"{msg.get('error')}"
            )
        elif kind == "goodbye":
            self.goodbye = msg
        # drained / poll_reply / hello acks need no folding here.

    def take_handoffs(self) -> list[dict]:
        """Normalize parked KV frames into the router's handoff-record
        shape (same as the in-process :meth:`Replica.take_handoffs`)."""
        frames, self._kv_frames = self._kv_frames, []
        out = []
        for f in frames:
            m = f.meta
            out.append({
                "request": request_from_wire(m["request"]),
                "arrival_s": float(m.get("arrival_s", 0.0)),
                "epoch": int(m.get("epoch", 0)),
                "digests": net.digests_from_wire(m.get("digests") or []),
                "payloads": f.blocks(),
                "offset": int(m.get("offset", 0)),
                "part": int(m.get("part", 0)),
                "last": bool(m.get("last", True)),
            })
        return out

    def adopt_handoff(self, rec: dict) -> None:
        """Forward a handoff record to this (decode) worker as an
        ``adopt`` KV frame, sliced against the worker's last pushed
        digest summary: leading blocks the summary says are already
        resident here are dropped from the wire (the worker's own
        adoption dedupes again, and a stale-summary overslice degrades
        to a cold prefill worker-side — never to wrong tokens). The
        ledger entry registers BEFORE the send so a peer that dies
        mid-write is quarantined with this request in its queued set —
        the standard retry path re-prefills it elsewhere."""
        request = rec["request"]
        rid = int(request.request_id)
        if rid not in self._outstanding:
            self._outstanding[rid] = (
                request, rec["arrival_s"], int(rec["epoch"] or 0)
            )
            self._queued.add(rid)
        payloads, offset = rec["payloads"], rec["offset"]
        if payloads and self.block_size:
            resident = self.match_digests(rec["digests"])
            drop = min(len(payloads),
                       max(0, resident // self.block_size - offset))
            if drop:
                payloads = payloads[drop:]
                offset += drop
        net.send_kv_frame(self.sock, {
            "op": "adopt",
            "request_id": rid,
            "epoch": int(rec["epoch"] or 0),
            "offset": offset,
            "last": rec["last"],
            "request": _request_to_wire(request),
            "arrival_s": rec["arrival_s"],
            "digests": net.digests_to_wire(rec["digests"]),
            "sizes": [len(p) for p in payloads],
        }, b"".join(payloads))

    def take_queued(self) -> list[tuple[Request, float]]:
        out = []
        for rid in sorted(self._queued):
            request, arrival_s, _epoch = self._outstanding.pop(rid)
            out.append((request, arrival_s))
        self._queued.clear()
        return out

    def lost_inflight(self) -> list[RequestState]:
        # Admitted-only: ids still in ``_queued`` never took a lane on
        # the worker, so they stay in the ledger for take_queued() to
        # re-route — same split the in-process Replica makes between
        # scheduler.active and scheduler.pending.
        out = []
        for rid in sorted(self._outstanding):
            if rid in self._queued:
                continue
            request, arrival_s, _epoch = self._outstanding[rid]
            state = RequestState(request=request, arrival_s=arrival_s)
            state.dropped = True
            out.append(state)
        for state in out:
            del self._outstanding[state.request.request_id]
        return out

    def finished_states(self) -> list[RequestState]:
        # Deadline-dropped results resolve the ledger (the worker pushes
        # them so the fleet reads idle) but are NOT finished work — same
        # split the in-process scheduler keeps between finished/dropped.
        return [self._results[k] for k in sorted(self._results)
                if not self._results[k].dropped]

    @property
    def dropped_count(self) -> int:
        return sum(1 for s in self._results.values() if s.dropped)

    def stats_snapshot(self) -> dict:
        return {
            "transport": "socket",
            "num_compiles": self.num_compiles,
            "heartbeat_seq": self.heartbeat_seq,
            "dropped": self.dropped_count,
            "stale_frames": self.stale_frames,
            "stale_heartbeats": self.stale_heartbeats,
            **self.hb_stats,
        }

    def do_warmup(self) -> None:
        pass  # workers warm up before reporting worker_ready

    def set_engine_clock(self, clock) -> None:
        pass  # the worker's clock is its own

    def send_op(self, op: str, **fields) -> None:
        net.send_frame(self.sock, {"op": op, **fields})

    def start_drain(self) -> None:
        self.send_op("drain")

    def shutdown(self) -> None:
        try:
            self.send_op("shutdown")
        except (OSError, net.ProtocolError):
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _request_to_wire(request: Request) -> dict:
    return {
        "prompt": [int(t) for t in request.prompt],
        "max_new_tokens": int(request.max_new_tokens),
        "temperature": float(request.temperature),
        "top_k": int(request.top_k),
        "top_p": float(request.top_p),
        "request_id": request.request_id,
        "deadline_s": request.deadline_s,
    }


def request_from_wire(d: dict) -> Request:
    return Request(
        prompt=[int(t) for t in d["prompt"]],
        max_new_tokens=int(d["max_new_tokens"]),
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)),
        top_p=float(d.get("top_p", 0.0)),
        request_id=d.get("request_id"),
        deadline_s=d.get("deadline_s"),
    )


def state_to_wire(state: RequestState) -> dict:
    """The result-frame payload: everything ``RequestState.metrics()``
    and greedy-parity checks read, nothing device-side."""
    return {
        "arrival_s": state.arrival_s,
        "bucket": state.bucket,
        "cached_len": state.cached_len,
        "decode_route": state.decode_route,
        "generated": [int(t) for t in state.generated],
        "admit_s": state.admit_s,
        "first_token_s": state.first_token_s,
        "finish_s": state.finish_s,
        "token_times_s": list(state.token_times_s),
        "dropped": state.dropped,
    }


def _state_from_wire(request: Request, d: dict) -> RequestState:
    state = RequestState(request=request, arrival_s=float(d["arrival_s"]))
    state.bucket = int(d.get("bucket", 0))
    state.cached_len = int(d.get("cached_len", 0))
    state.decode_route = bool(d.get("decode_route", False))
    state.generated = [int(t) for t in d.get("generated", ())]
    state.admit_s = d.get("admit_s")
    state.first_token_s = d.get("first_token_s")
    state.finish_s = d.get("finish_s")
    state.token_times_s = [float(t) for t in d.get("token_times_s", ())]
    state.dropped = bool(d.get("dropped", False))
    return state


class ReplicaRouter:
    """Fronts ``cfg.replicas`` identical :class:`ServingEngine` replicas.

    ``submit()`` picks a replica (policy + shed check) and enqueues;
    ``step()`` ticks every non-quarantined replica once; ``run()`` drains
    to idle. ``model`` is the port's GPT-2 or Llama with its weights
    loaded: the replicas share it (with ``quant='int8'`` each gets its
    own copy, which its engine quantizes in place). ``cfg`` is a
    :class:`~..config.ServingConfig`; ``clock`` is injectable exactly like
    the engine's; ``device`` is every replica's (``None`` = the GPU).
    ``telemetry_dir`` (optional) gives every replica a stamped
    :class:`~..telemetry.Telemetry` bundle in that shared dir.
    ``transports`` replaces the in-process replicas with ready transports
    (:class:`SocketReplica`; ``model`` is then unused).
    """

    def __init__(self, model, cfg, *, clock=time.monotonic,
                 seed: int = 0, emit=None, static_batching: bool = False,
                 telemetry_dir: str | None = None, transports=None,
                 device=None):
        n = len(transports) if transports is not None else int(
            getattr(cfg, "replicas", 1)
        )
        if n < 1:
            raise ValueError(
                f"serving.replicas must be >= 1, got {n} — 1 serves "
                "through a single engine, > 1 fronts N replicas with a "
                "ReplicaRouter"
            )
        if static_batching:
            raise NotImplementedError(
                f"serving.replicas={n} x static_batching: the "
                "static-batching baseline exists to isolate ONE engine's "
                "continuous-batching delta (tools/serve_bench.py) — a "
                "router in front would re-mix admission policy into the "
                "measurement. Benchmark static on a single engine."
            )
        self.policy = str(getattr(cfg, "router_policy", "least_loaded"))
        if self.policy not in ROUTER_POLICIES:
            raise ValueError(
                f"serving.router_policy must be one of {ROUTER_POLICIES}, "
                f"got {self.policy!r}"
            )
        if (self.policy == "prefix_affinity"
                and not getattr(cfg, "prefix_cache", False)):
            raise ValueError(
                "serving.router_policy='prefix_affinity' x "
                "prefix_cache=False: affinity scores replicas by their "
                "prefix-trie digest, which only exists with "
                "serving.prefix_cache=true — enable the cache or use "
                "router_policy='least_loaded'"
            )
        self.shed_policy = str(getattr(cfg, "shed_policy", "off"))
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"serving.shed_policy must be one of {SHED_POLICIES}, got "
                f"{self.shed_policy!r}"
            )
        self.shed_percentile = float(getattr(cfg, "shed_percentile", 50.0))
        if not 0.0 < self.shed_percentile <= 100.0:
            raise ValueError(
                "serving.shed_percentile must be in (0, 100], got "
                f"{self.shed_percentile}"
            )
        self.cfg = cfg
        self.clock = clock
        self.telemetry_dir = telemetry_dir
        self.events: list[dict] = []
        self._emit = emit if emit is not None else self.events.append
        self.heartbeat_timeout_s = float(
            getattr(cfg, "heartbeat_timeout_s", 0.0) or 0.0
        )
        #: Last staleness-sweep timestamp — lets the sweep tell a
        #: worker's silence apart from its OWN pause (see
        #: :meth:`check_heartbeats`).
        self._last_sweep_s: float | None = None
        # Socket pump idle wait (real-clock fleets only): step() blocks
        # up to this long on the fleet's sockets when a tick moved
        # nothing, instead of burning the workers' CPU in a hot poll.
        self.io_wait_s = 0.002 if clock is time.monotonic else 0.0
        self.replicas: list[Replica] = []
        if transports is not None:
            self.replicas = list(transports)
        else:
            # int8 weights are quantized in place by each engine, so each
            # replica gets its own copy of the float model, taken before
            # any engine quantizes one.
            replica_models = (
                [model] + [copy.deepcopy(model) for _ in range(n - 1)]
                if getattr(cfg, "quant", "none") == "int8" else [model] * n
            )
            for i in range(n):
                tel = (
                    Telemetry(enabled=True, out_dir=telemetry_dir,
                              process_index=i)
                    if telemetry_dir is not None else NULL_TELEMETRY
                )
                engine = ServingEngine(
                    replica_models[i], cfg, clock=clock, seed=seed,
                    telemetry=tel, device=device,
                    # Replica-tagged events into the ROUTER's single
                    # ordered stream — per-engine step counters would
                    # interleave ambiguously without the tag.
                    emit=lambda rec, i=i: self._emit(
                        {**rec, "replica": i}
                    ),
                )
                self.replicas.append(Replica(index=i, engine=engine,
                                             telemetry=tel))
        # Role topology (serving.role, docs/SERVING.md disaggregation):
        # validated HERE, at fleet build, because only the router sees
        # every member's role — each engine alone is a legal config.
        self.roles = [
            str(getattr(r, "role", "unified")) for r in self.replicas
        ]
        if ("decode" in self.roles
                and not any(x in ("prefill", "unified")
                            for x in self.roles)):
            raise ValueError(
                "decode-only fleet: every replica has serving.role="
                "'decode', so no replica can run a prefill and nothing "
                "is ever admitted — give at least one worker role="
                "'prefill' (or 'unified')"
            )
        if ("prefill" in self.roles
                and not any(x in ("decode", "unified")
                            for x in self.roles)):
            raise ValueError(
                "prefill-only fleet: every replica has serving.role="
                "'prefill', so handed-off chains have no decode replica "
                "to land on — give at least one worker role='decode' "
                "(or 'unified')"
            )
        #: Sticky multi-part handoff routing: (request_id, epoch) ->
        #: decode replica index, cleared on the chain's last part.
        self._handoff_routes: dict[tuple[int, int], int] = {}
        self.handoffs = 0
        self.handoff_parts = 0
        # Globally-unique request ids across replicas: each engine's
        # scheduler counts from 0, so the router must number requests
        # BEFORE dispatch or two replicas would mint colliding ids (and
        # colliding PRNG chains — fold_in(seed, request_id)).
        self._next_id = 0
        self._rr = 0  # round-robin cursor
        self.routes: dict[int, int] = {}  # request_id -> replica index
        self.shed: list[dict] = []
        self.failed: list[RequestState] = []
        self.rerouted = 0
        self.tick_count = 0
        # At-most-once retry ledger (serving.request_retry): request_id
        # -> attempt epoch. Every reroute/retry bumps the epoch; the
        # epoch travels in the submit frame and comes back on every
        # admitted/result frame, so late frames from a previous attempt
        # are discarded transport-side (SocketReplica.stale_frames).
        self.request_retry = bool(getattr(cfg, "request_retry", False))
        self.epochs: dict[int, int] = {}
        self.retried = 0
        #: Same-rid results observed on TWO replicas by ``finished()`` —
        #: the double-delivery the epoch discipline exists to prevent
        #: (chaos pins this at 0).
        self.duplicate_deliveries = 0

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _live(self) -> list[Replica]:
        return [r for r in self.replicas if r.live]

    def _pick(self, now: float,
              request: Request | None = None) -> Replica:
        live = self._live()
        if not live:
            raise RuntimeError(
                "ReplicaRouter has no live replicas (all draining or "
                "quarantined) — cannot accept new requests"
            )
        if any(getattr(r, "role", "unified") == "prefill" for r in live):
            # Two-stage dispatch (disaggregated fleet): NEW requests land
            # on the prefill stage only — decode replicas get their work
            # by handoff. If every prefill/unified replica is dead, the
            # filter lifts: a decode-role ENGINE prefills fine, and a
            # degraded unified fleet beats a refused request.
            front = [
                r for r in live
                if getattr(r, "role", "unified") != "decode"
            ]
            if front:
                live = front
        if self.policy == "round_robin":
            r = live[self._rr % len(live)]
            self._rr += 1
            return r
        # least_loaded key: gauges pulled FRESH at this dispatch. Queue
        # depth first (each queued request costs a full prefill+decode
        # ahead of ours), then busy lanes, then pool occupancy (a fuller
        # pool admits later even when a lane is free); index breaks ties
        # deterministically.
        loads = {}

        def load(r: Replica):
            if r.index not in loads:
                g = r.load_gauges(now)
                loads[r.index] = (
                    g["pending"], g["active"], g["used_blocks"], r.index
                )
            return loads[r.index]

        if self.policy == "prefix_affinity" and request is not None:
            # Probe every live replica's trie (read-only; for a socket
            # replica the probe walks the digest summary its heartbeat
            # pushed — zero cross-process round trips). The chain
            # digests are hashed ONCE here and handed to every probe, so
            # dispatch costs O(prompt) hashing instead of O(replicas x
            # prompt) — replicas share a block size, so one digest chain
            # fits all. Max cached-prefix length wins; among equals the
            # least-loaded key tie-breaks, so N replicas holding the same
            # hot prefix still spread its traffic.
            digests = chain_digests(
                list(request.prompt), live[0].block_size
            )
            matches = [
                (r.match_digests(digests), r)
                for r in live
            ]
            best = max(m for m, _ in matches)
            if best > 0:
                choice = min(
                    (r for m, r in matches if m == best), key=load
                )
                # Starvation guard (module docstring): cached-prefix
                # savings are worth at most one prefill — not a queue
                # already a full lane-batch deeper than the idlest
                # replica's.
                floor = min(load(r)[0] for r in live)
                if load(choice)[0] - floor <= choice.slots_n:
                    return choice
        return min(live, key=load)

    def _admit_estimate(self, replica: Replica, now: float) -> float:
        """Estimated submit->first-token latency on ``replica``, from its
        gauges + latency histograms:

        - queue-wait component: the observed queue-wait percentile,
          floored by the head-of-queue's LIVE age
          (``oldest_queued_age_s``) — the histograms only learn about a
          wedge after it clears, the gauge sees it while it is happening;
        - backlog component: ``pending`` x the prefill percentile — every
          queued request ahead of this one costs at least one SERIAL
          prefill on this replica before ours can start, which is the
          signal that fires during a cold-start burst (100x offered
          load lands before any queue-wait sample exists);
        - plus one prefill for the request itself.

        A socket replica supplies the same three parts from its pushed
        heartbeat (the worker computes its own histogram percentiles)
        plus the router's submit ledger — the formula does not fork on
        transport.
        """
        queue_wait, prefill, pending = replica.estimate_parts(
            now, self.shed_percentile
        )
        return queue_wait + pending * prefill + prefill

    def submit(self, request: Request) -> RequestState:
        """Route one request: pick a replica, shed if its deadline is
        infeasible there (typed ``request_shed`` event + :class:`
        RequestShed` raise — no queue slot, no prefill), else enqueue."""
        if request.request_id is None:
            request.request_id = self._next_id
        self._next_id = max(self._next_id, int(request.request_id)) + 1
        now = self.clock()
        replica = self._pick(now, request)
        if (self.shed_policy == "deadline"
                and request.deadline_s is not None):
            est = self._admit_estimate(replica, now)
            if now + est > request.deadline_s:
                rec = serving_event(
                    "request_shed", self.tick_count,
                    request_id=request.request_id,
                    replica=replica.index,
                    deadline_s=round(float(request.deadline_s), 6),
                    estimated_first_token_s=round(now + est, 6),
                    reason="deadline_infeasible",
                )
                self._emit(rec)
                replica.telemetry.note_event(rec)
                self.shed.append(rec)
                raise RequestShed(
                    f"request {request.request_id} shed: estimated first "
                    f"token at {now + est:.4f}s > deadline "
                    f"{request.deadline_s:.4f}s on replica "
                    f"{replica.index}",
                    rec,
                )
        # Arrival stamped with the ROUTER's now: the request arrived when
        # it hit the router, whatever the replica's clock reads. A
        # submit that dies on the wire (ProtocolError from a peer that
        # vanished since its last heartbeat) quarantines that replica
        # and re-picks — the caller never sees a transport fault for a
        # request no worker ever owned.
        epoch = self.epochs.setdefault(int(request.request_id), 0)
        while True:
            try:
                state = replica.submit_request(request, now, epoch)
                break
            except net.ProtocolError as exc:
                self._quarantine(replica, exc)
                replica = self._pick(now, request)
        self.routes[int(request.request_id)] = replica.index
        return state

    # ------------------------------------------------------------------
    # stepping + failure handling
    # ------------------------------------------------------------------

    def step_replica(self, index: int) -> bool:
        """One transport step on one replica (engine step in-process,
        socket pump for a fleet worker), with quarantine-on-raise.
        Returns False when that replica is idle (or just died)."""
        r = self.replicas[index]
        if r.quarantined:
            return False
        try:
            return r.step()
        except Exception as exc:  # noqa: BLE001 — any step fault kills it
            self._quarantine(r, exc)
            return False

    def step(self) -> bool:
        """One router tick: step every non-quarantined replica (draining
        replicas included — they must finish their in-flight work), then
        sweep for stale heartbeats. Returns False when the whole fleet
        is idle."""
        self.tick_count += 1
        busy = False
        for r in self.replicas:
            busy = self.step_replica(r.index) or busy
        busy = self.dispatch_handoffs() or busy
        self.check_heartbeats()
        if busy and self.io_wait_s:
            socks = [
                r.sock for r in self.replicas
                if r.heartbeat_expected and not r.quarantined
            ]
            if socks:
                # Real-clock fleet: the workers do the stepping, so wait
                # on their sockets instead of hot-polling one core out
                # from under them.
                select.select(socks, [], [], self.io_wait_s)
        return busy

    # ------------------------------------------------------------------
    # prefill→decode handoff routing (docs/SERVING.md disaggregation)
    # ------------------------------------------------------------------

    def dispatch_handoffs(self) -> bool:
        """Collect every replica's pending handoffs (engine records
        in-process, parked KV frames over sockets) and forward each to
        a decode replica. Returns True when anything moved."""
        moved = False
        for src in self.replicas:
            if src.quarantined:
                # Frames a now-dead prefill worker pushed before dying
                # are dropped on the floor: its quarantine already
                # retried every unresolved request under a bumped
                # epoch, so acting on them would double-deliver.
                continue
            take = getattr(src, "take_handoffs", None)
            if take is None:
                continue
            for rec in take():
                moved = True
                self._route_handoff(src, rec)
        return moved

    def _pick_decode(self, now: float, rec: dict,
                     exclude) -> "Replica | None":
        """Decode-stage placement: among live decode replicas (falling
        back to unified ones, then — last resort, mirroring
        ``_retry_target`` — a live draining non-prefill replica), the
        one whose trie already holds the longest run of the chain's
        digests wins (the wire then ships only the novel tail);
        least-loaded breaks ties and serves digest-cold chains."""
        live = [r for r in self._live() if r is not exclude]
        pool = [r for r in live
                if getattr(r, "role", "unified") == "decode"]
        if not pool:
            pool = [r for r in live
                    if getattr(r, "role", "unified") != "prefill"]
        if not pool:
            pool = [
                r for r in self.replicas
                if (r.draining and not r.quarantined and r is not exclude
                    and getattr(r, "role", "unified") != "prefill")
            ]
        if not pool:
            return None
        loads = {}

        def load(r):
            if r.index not in loads:
                g = r.load_gauges(now)
                loads[r.index] = (
                    g["pending"], g["active"], g["used_blocks"], r.index
                )
            return loads[r.index]

        digests = rec.get("digests") or []
        if digests:
            matches = [(r.match_digests(digests), r) for r in pool]
            best = max(m for m, _ in matches)
            if best > 0:
                choice = min(
                    (r for m, r in matches if m == best), key=load
                )
                # Same starvation guard as admission (_pick): affinity
                # concentrates warm chains, it must not wedge one decode
                # replica while its siblings idle.
                floor = min(load(r)[0] for r in pool)
                if load(choice)[0] - floor <= choice.slots_n:
                    return choice
        return min(pool, key=load)

    def _route_handoff(self, src, rec: dict) -> None:
        """Forward one handoff record: on a chain's FIRST part, release
        the source's ledger entry (epoch-checked — a handoff from a
        superseded attempt is a stale frame), pick the decode target,
        and move the route; later parts follow the sticky route. A
        send that dies mid-forward quarantines the target, whose ledger
        already holds the request — the standard retry path re-prefills
        it under a bumped epoch."""
        rid = int(rec["request"].request_id)
        if rec["epoch"] is None:
            rec["epoch"] = self.epochs.get(rid, 0)
        key = (rid, int(rec["epoch"]))
        target_index = self._handoff_routes.get(key)
        if target_index is None:
            outstanding = getattr(src, "_outstanding", None)
            if outstanding is not None:
                entry = outstanding.get(rid)
                if entry is None or entry[2] != int(rec["epoch"]):
                    # The request was already retried elsewhere (the
                    # prefill worker is half-dead or slow): this chain
                    # belongs to a superseded attempt.
                    src.stale_frames += 1
                    return
                outstanding.pop(rid)
                src._queued.discard(rid)
            now = self.clock()
            target = self._pick_decode(now, rec, src)
            if target is None:
                state = RequestState(
                    request=rec["request"], arrival_s=rec["arrival_s"]
                )
                state.dropped = True
                self.failed.append(state)
                self._emit(serving_event(
                    "request_failed", self.tick_count, request_id=rid,
                    replica=src.index, reason="no_decode_replica",
                ))
                return
            self._handoff_routes[key] = target.index
            self.routes[rid] = target.index
            self.handoffs += 1
            self._emit(serving_event(
                "request_handoff", self.tick_count, request_id=rid,
                replica=src.index, target=target.index,
                epoch=int(rec["epoch"]), blocks=len(rec["payloads"]),
            ))
        else:
            target = self.replicas[target_index]
            if target.quarantined:
                # Mid-chain death: the quarantine already rerouted the
                # request (it was in the target's queued ledger) — the
                # remaining parts are moot.
                self._handoff_routes.pop(key, None)
                return
        self.handoff_parts += 1
        try:
            target.adopt_handoff(rec)
        except net.ProtocolError as exc:
            self._quarantine(target, exc)
        if rec["last"]:
            self._handoff_routes.pop(key, None)

    def check_heartbeats(self, now: float | None = None) -> None:
        """Quarantine socket replicas whose last heartbeat is older than
        ``serving.heartbeat_timeout_s`` (0 = sweep disabled). Runs
        through the SAME quarantine path as a step fault: in-flight
        work on the stale worker is reported lost, queued work reroutes
        to the survivors.

        Pause-aware: when the ROUTER itself went dark between sweeps —
        blocked in a supervisor respawn (worker boot + dial can take
        seconds), a host stall, a GC-style pause — silence over that
        window says nothing about the workers, whose heartbeats were
        piling up in socket buffers nobody pumped. Charging them for
        our own dead air quarantines healthy workers and (worst case)
        cascades: each false restart blocks the router again and
        condemns the next survivor. So a sweep gap larger than half the
        timeout is credited back to every live replica and detection
        resumes from now — a genuinely stalled worker still ages across
        the normal millisecond-cadence sweeps."""
        if not self.heartbeat_timeout_s:
            return
        now = self.clock() if now is None else now
        prev, self._last_sweep_s = self._last_sweep_s, now
        if prev is not None:
            gap = now - prev
            if gap > self.heartbeat_timeout_s / 2.0:
                for r in self.replicas:
                    if r.heartbeat_expected and not r.quarantined:
                        r.last_heartbeat_s = min(
                            r.last_heartbeat_s + gap, now
                        )
                return
        for r in self.replicas:
            if not r.heartbeat_expected or r.quarantined:
                continue
            age = now - r.last_heartbeat_s
            if age > self.heartbeat_timeout_s:
                self._quarantine(r, StaleHeartbeat(
                    f"no heartbeat from worker {r.index} for "
                    f"{age:.3f}s (> heartbeat_timeout_s="
                    f"{self.heartbeat_timeout_s})"
                ))

    def _bump_epoch(self, rid: int) -> int:
        epoch = self.epochs.get(rid, 0) + 1
        self.epochs[rid] = epoch
        return epoch

    def _retry_target(self, now: float,
                      request: Request | None = None) -> Replica | None:
        """Survivor for quarantine-displaced work. Normal dispatch when
        any non-draining replica is live; as a LAST RESORT a live
        draining replica — drain closes the front door to NEW work, but
        displaced work was already accepted, and failing it while a live
        engine could still serve it would break the self-healing
        contract. None = fleet fully dark."""
        if self._live():
            return self._pick(now, request)
        draining = [r for r in self.replicas
                    if r.draining and not r.quarantined]
        if not draining:
            return None
        return min(
            draining,
            key=lambda r: (r.load_gauges(now)["pending"], r.index),
        )

    def _quarantine(self, replica: Replica, exc: Exception) -> None:
        replica.quarantined = True
        replica.error = f"{type(exc).__name__}: {exc}"
        self._emit(event_record(
            "replica_quarantined", self.tick_count,
            replica=replica.index, error=replica.error,
        ))
        now = self.clock()
        # In-flight requests lost their KV with the replica. With
        # ``serving.request_retry`` they are RE-SUBMITTED on a survivor
        # from scratch (greedy decode is deterministic, so the retry's
        # tokens are identical to what the dead attempt would have
        # produced) under a bumped attempt epoch — any late result frame
        # the half-dead worker still manages to push carries the old
        # epoch and is discarded transport-side, so the request resolves
        # EXACTLY once. Without retry (or without survivors) each loss
        # is reported, typed, as before.
        for state in replica.lost_inflight():
            rid = int(state.request.request_id)
            target = (self._retry_target(now, state.request)
                      if self.request_retry else None)
            if target is not None:
                epoch = self._bump_epoch(rid)
                self.retried += 1
                self._emit(serving_event(
                    "request_retried", self.tick_count,
                    request_id=rid, replica=replica.index,
                    epoch=epoch, reason="replica_quarantined",
                ))
                # Original arrival time: the lost attempt is latency the
                # request really experienced — it stays in its TTFT.
                target.reroute_in(state.request, state.arrival_s,
                                  epoch=epoch)
                self.routes[rid] = target.index
            else:
                self.failed.append(state)
                self._emit(serving_event(
                    "request_failed", self.tick_count,
                    request_id=rid,
                    replica=replica.index, reason="replica_quarantined",
                ))
        # Queued (never admitted) requests lost nothing but time:
        # re-route them through normal dispatch. No shed re-check — the
        # front door already accepted them; if the detour blew their
        # deadline the surviving engine's admit pass drops them there.
        # The epoch bumps here too: one discipline for every frame the
        # dead worker might still emit about a request it no longer owns.
        for request, arrival_s in replica.take_queued():
            rid = int(request.request_id)
            # Normal dispatch, affinity included, with the same
            # last-resort draining fallback as the retry path above.
            target = self._retry_target(now, request)
            if target is None:
                # Fleet fully dark: nothing to reroute onto. Typed
                # failure instead of a RuntimeError out of _pick — the
                # router object stays usable for replace_replica().
                state = RequestState(request=request, arrival_s=arrival_s)
                state.dropped = True
                self.failed.append(state)
                self._emit(serving_event(
                    "request_failed", self.tick_count,
                    request_id=rid, replica=replica.index,
                    reason="no_live_replicas",
                ))
                continue
            self.rerouted += 1
            self._emit(serving_event(
                "request_rerouted", self.tick_count,
                request_id=rid,
                replica=replica.index, reason="replica_quarantined",
            ))
            # Straight into the target's scheduler with the ORIGINAL
            # arrival time: the detour's queueing is real latency the
            # request experienced and must stay in its TTFT.
            target.reroute_in(request, arrival_s,
                              epoch=self._bump_epoch(rid))
            self.routes[rid] = target.index
        replica.close()

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def drain(self, index: int) -> None:
        """Graceful scale-down of one replica: no new work routes to it,
        accepted work (queued + in-flight) completes token-identically,
        and once idle its pool is back to the empty-engine state."""
        r = self.replicas[index]
        r.draining = True
        r.start_drain()
        self._emit(event_record(
            "replica_draining", self.tick_count, replica=index,
        ))

    def quarantine_replica(self, index: int, exc: Exception) -> None:
        """Externally-detected death (the fleet supervisor sees a child
        exit or kills a hung process): run the SAME quarantine path a
        step fault takes — retry/reroute the dead worker's work, close
        its socket. Idempotent on an already-quarantined replica."""
        r = self.replicas[index]
        if not r.quarantined:
            self._quarantine(r, exc)

    def replace_replica(self, index: int, transport) -> None:
        """Swap a quarantined replica's slot for a freshly-connected
        transport (the supervisor's restart rejoin). The slot keeps its
        index — routes, telemetry stamping and dispatch tie-breaks all
        key on it — and the replacement starts live, so the next
        dispatch can route to it immediately."""
        old = self.replicas[index]
        if not old.quarantined:
            raise RuntimeError(
                f"replace_replica({index}): replica is live — quarantine "
                "it first (replacing a serving replica would strand its "
                "ledger)"
            )
        if int(transport.index) != int(index):
            raise ValueError(
                f"replace_replica({index}): transport carries index "
                f"{transport.index}"
            )
        # Results the dead replica delivered BEFORE it died are real
        # completed work — finished() walks self.replicas, so they must
        # move into the replacement's ledger or the swap would silently
        # un-complete them.
        harvest = getattr(old, "_results", None)
        if harvest and hasattr(transport, "_results"):
            for rid, state in harvest.items():
                transport._results.setdefault(rid, state)
        old.close()
        self.replicas[index] = transport
        self._emit(event_record(
            "replica_replaced", self.tick_count, replica=index,
        ))

    # ------------------------------------------------------------------
    # lifecycle + introspection
    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Ready every replica's program set now. The fleet compile pin:
        ``replicas * (len(prompt_buckets) + len(suffix_buckets) + 1)``
        programs, ``+ 1`` per replica with speculation on — and ZERO more
        in steady state."""
        for r in self.replicas:
            r.do_warmup()

    @property
    def num_compiles(self) -> int:
        return sum(r.num_compiles for r in self.replicas)

    @property
    def idle(self) -> bool:
        return all(
            r.quarantined or r.engine_idle for r in self.replicas
        )

    def run(self, max_steps: int = 0) -> list[RequestState]:
        """Tick until the fleet is idle; returns every finished state
        fleet-wide in request-id order."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps and steps >= max_steps:
                break
        return self.finished()

    def finished(self) -> list[RequestState]:
        by_rid: dict[int, RequestState] = {}
        dups = 0
        for r in self.replicas:
            # A quarantined replica's COMPLETED requests were delivered
            # before it died — they count.
            for state in r.finished_states():
                rid = int(state.request.request_id)
                if rid in by_rid:
                    # Two replicas both completed one request — the
                    # double delivery the epoch discipline prevents.
                    # Keep the routed owner's copy, count the breach.
                    dups += 1
                    if self.routes.get(rid) == r.index:
                        by_rid[rid] = state
                else:
                    by_rid[rid] = state
        self.duplicate_deliveries = dups
        return [by_rid[rid] for rid in sorted(by_rid)]

    def gauges(self) -> list[dict]:
        """Fresh per-replica gauges (one router-tick snapshot)."""
        now = self.clock()
        return [
            {"replica": r.index, "draining": r.draining,
             "quarantined": r.quarantined,
             **(({} if r.quarantined
                 else r.load_gauges(now)))}
            for r in self.replicas
        ]

    def stats(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "router_policy": self.policy,
            "shed_policy": self.shed_policy,
            "roles": list(self.roles),
            "handoffs": self.handoffs,
            "handoff_parts": self.handoff_parts,
            "shed": len(self.shed),
            "rerouted": self.rerouted,
            "retried": self.retried,
            "failed": len(self.failed),
            "duplicate_deliveries": self.duplicate_deliveries,
            "stale_frames": sum(
                getattr(r, "stale_frames", 0) for r in self.replicas
            ),
            "stale_heartbeats": sum(
                getattr(r, "stale_heartbeats", 0) for r in self.replicas
            ),
            "quarantined": [
                {"replica": r.index, "error": r.error}
                for r in self.replicas if r.quarantined
            ],
            "draining": [
                r.index for r in self.replicas if r.draining
            ],
            "ticks": self.tick_count,
            "num_compiles": self.num_compiles,
            "per_replica": [
                {"replica": r.index, **r.stats_snapshot()}
                for r in self.replicas
            ],
        }

    def write_trace(self) -> None:
        """Flush every replica's stamped telemetry artifacts (trace,
        spans, stats)."""
        for r in self.replicas:
            r.telemetry.write_trace()

    def set_clock(self, clock, per_replica=None) -> None:
        """Swap the router clock and every replica engine's clock —
        benches install an offset/virtual clock after warmup so compile
        time stays outside the timed window. ``per_replica`` (optional,
        ``fn(index) -> clock``) gives each replica its OWN clock: the
        virtual-time N-card simulation of a serving bench."""
        self.clock = clock
        # The sweep's pause detector must not read a timebase swap as a
        # 15-minute router stall (or as instant staleness).
        self._last_sweep_s = None
        for r in self.replicas:
            r.set_engine_clock(
                per_replica(r.index) if per_replica is not None else clock
            )

    def shutdown_fleet(self, *, wait_s: float = 5.0) -> None:
        """Politely stop every socket worker: send the ``shutdown`` op,
        pump for goodbyes up to ``wait_s``, close the connections.
        In-process replicas are untouched (nothing to stop)."""
        socks = [
            r for r in self.replicas
            if r.heartbeat_expected and not r.quarantined
        ]
        for r in socks:
            r.shutdown()
        deadline = time.monotonic() + wait_s
        while (time.monotonic() < deadline
               and any(r.goodbye is None for r in socks)):
            for r in socks:
                if r.goodbye is None:
                    try:
                        r.step()
                    except Exception:  # noqa: BLE001 — already stopping
                        r.goodbye = {"type": "goodbye", "lost": True}
            pending = [r.sock for r in socks if r.goodbye is None]
            if pending:
                select.select(pending, [], [], 0.05)
        for r in socks:
            r.close()


def dial_worker(index: int, host: str, port: int, *,
                clock=time.monotonic,
                connect_timeout_s: float = 60.0) -> SocketReplica:
    """Dial ONE worker endpoint (bounded connect retry + backoff — a
    just-bound or just-restarted worker can refuse the first SYN), run
    the hello handshake, and return the :class:`SocketReplica`. Shared
    by fleet bring-up and the supervisor's restart re-dial."""
    sock = net.connect_with_retry(
        host, int(port), deadline_s=connect_timeout_s
    )
    sock.setblocking(False)
    try:
        decoder = net.FrameDecoder()
        frames = net.recv_frames_blocking(
            sock, decoder, timeout_s=connect_timeout_s
        )
        hello = frames[0]
        if hello.get("type") != "hello":
            raise net.ProtocolError(
                f"worker {index} opened with {hello.get('type')!r}, "
                "expected 'hello'"
            )
    except Exception:
        sock.close()
        raise
    return SocketReplica(index, sock, hello, clock=clock,
                         decoder=decoder, backlog=frames[1:])


def connect_fleet(cfg, endpoints, *, clock=time.monotonic, emit=None,
                  connect_timeout_s: float = 60.0) -> ReplicaRouter:
    """Dial a list of ``(host, port)`` worker endpoints, run the hello
    handshake on each, and front them with a :class:`ReplicaRouter`
    whose replicas are :class:`SocketReplica` transports — dispatch,
    shedding, draining and quarantine all run the exact in-process code
    paths on pushed state. ``cfg`` is the ``ServingConfig`` the workers
    were launched with (policy/shed/heartbeat knobs must agree)."""
    transports = [
        dial_worker(i, host, port, clock=clock,
                    connect_timeout_s=connect_timeout_s)
        for i, (host, port) in enumerate(endpoints)
    ]
    return ReplicaRouter(
        None, cfg, clock=clock, emit=emit, transports=transports,
    )
