"""Fleet replica worker: one ServingEngine behind one socket.

``python -m distributeddeeplearning_tpu_torch.serving.worker`` is the
child process ``cli serve --fleet N`` spawns per replica. It builds ONE
engine on its ``--device`` (the GPU unless ``--device cpu``; the decode
kernel is built and loaded in ``warmup``, and a build that fails fails the
worker before it reports ready), binds a listening socket, prints a single
``worker_ready`` JSON line (the parent parses the port from it), accepts
the router's connection, and then runs the serve loop:

- **ops served** (router -> worker frames, serving/net.py framing):
  ``submit`` (enqueue; arrival timestamp travels with the frame so TTFT
  clocks from when the request hit the ROUTER), ``poll`` (pull the
  per-request token deltas since the last poll — the streaming read),
  ``drain`` (intake cut; accepted work completes token-identically),
  ``shutdown`` (drain, flush, exit 0), ``heartbeat_ack`` (the router's
  receipt for a pushed heartbeat).
- **pushed state** (worker -> router): an ``admitted`` frame the step a
  request takes a lane, a ``result`` frame the step it finishes (or is
  deadline-dropped), and a periodic **heartbeat** every
  ``serving.heartbeat_interval_s`` carrying the scheduler gauges, the
  prefix-trie ``chain_digests`` summary (MRU-first, capped), the program
  counter (``num_compiles``), and the worker's own queue-wait/prefill histogram
  percentiles. The router's least_loaded / prefix_affinity / shed
  policies run entirely on this pushed state — ZERO cross-process round
  trips on the submit path.

SIGTERM is the supervisor-preemption contract (supervisor.py): cut
intake, finish every in-flight request, push their results, flush the
telemetry/flight artifacts, exit ``EXIT_PREEMPTED`` so the fleet
supervisor classifies the exit as clean-do-not-restart. A clean
``shutdown`` op exits 0 the same way. Before it exits, the process syncs
the device and prints one ``worker_launches`` JSON line: its engine's
decode calls and the paged kernels' launches (``ops/paged_attention``'s
counts), which a caller holds against decode calls x layers.

:class:`ReplicaWorker` holds the whole loop body with an injectable
clock and sleep so tests drive it deterministically over a socketpair —
no subprocess, no wall clock (tests/test_torch_serving_worker.py).
"""

from __future__ import annotations

import argparse
import json
import os
import select
import signal
import socket
import sys
import time

from ..supervisor import EXIT_FAULT, EXIT_PREEMPTED
from ..telemetry import NULL_TELEMETRY
from . import net
from .router import _request_to_wire, request_from_wire, state_to_wire

#: Heartbeat digest-summary cap: bounds the heartbeat frame regardless of
#: pool size.
DIGEST_SUMMARY_LIMIT = 512

#: Respawn-attempt counter the fleet supervisor stamps on a restarted
#: worker's environment (mirrors supervisor.ATTEMPT_ENV for training):
#: one-shot injected faults are armed ONLY at attempt 0, so a restarted
#: worker never re-fires the fault that killed its predecessor.
ATTEMPT_ENV = "DDL_WORKER_ATTEMPT"
#: Which replica index the ``serving.fault_injection`` spec arms
#: (default 0) — chaos targets ONE worker, the rest stay healthy.
FAULT_WORKER_ENV = "DDL_SERVE_FAULT_WORKER"


def armed_fault(scfg, replica_index: int, env=None):
    """The ``(kind, step)`` this process should fire, or None. Armed iff
    a fault spec is set, this is the targeted replica index, and this is
    the worker's FIRST attempt (``DDL_WORKER_ATTEMPT`` unset/0)."""
    from .engine import parse_fault_injection

    env = os.environ if env is None else env
    fault = parse_fault_injection(getattr(scfg, "fault_injection", ""))
    if fault is None:
        return None
    if int(env.get(ATTEMPT_ENV) or 0) != 0:
        return None
    if int(env.get(FAULT_WORKER_ENV) or 0) != int(replica_index):
        return None
    return fault


def check_fleet_composition(cfg, fleet: int, *,
                            static_batching: bool = False) -> None:
    """Config-time fences for ``cli serve --fleet N`` (fail BY NAME
    before any process is spawned). ``cfg`` is a ServingConfig."""
    if fleet < 1:
        raise ValueError(
            f"serve --fleet must be >= 1, got {fleet} — each fleet "
            "worker is one engine process; 0 workers serve nothing"
        )
    if static_batching:
        raise NotImplementedError(
            f"serve --fleet {fleet} x static_batching: the static-"
            "batching baseline exists to isolate ONE engine's "
            "continuous-batching delta — a socket fleet in front would "
            "re-mix admission policy into the measurement. Benchmark "
            "static on a single in-process engine."
        )
    host = getattr(cfg, "worker_host", "127.0.0.1")
    if not isinstance(host, str) or not host.strip():
        raise ValueError(
            f"serving.worker_host must be a non-empty host string, got "
            f"{host!r}"
        )
    port = int(getattr(cfg, "worker_port", 0))
    if port < 0 or port > 65535:
        raise ValueError(
            f"serving.worker_port must be in [0, 65535] (0 = ephemeral "
            f"per worker), got {port}"
        )
    if port and port + fleet - 1 > 65535:
        raise ValueError(
            f"serving.worker_port={port} x --fleet {fleet}: worker i "
            f"binds worker_port + i, and {port + fleet - 1} overflows "
            "the port range — lower the base port or the fleet size"
        )
    interval = float(getattr(cfg, "heartbeat_interval_s", 0.0))
    if interval <= 0:
        raise ValueError(
            f"serving.heartbeat_interval_s must be > 0 for a socket "
            f"fleet, got {interval} — the router's least_loaded / "
            "prefix_affinity / shed policies run on pushed heartbeats; "
            "a worker that never heartbeats is permanently stale"
        )
    timeout = float(getattr(cfg, "heartbeat_timeout_s", 0.0))
    if timeout and timeout <= interval:
        raise ValueError(
            f"serving.heartbeat_timeout_s={timeout} must exceed "
            f"heartbeat_interval_s={interval} (or be 0 to disable the "
            "staleness sweep) — a timeout under one interval quarantines "
            "healthy workers"
        )


class ReplicaWorker:
    """The serve-loop body for one fleet worker.

    ``conn`` is the (nonblocking) socket to the router; ``clock`` and
    ``sleep`` are injectable for deterministic tests.

    Drive it with :meth:`pump` until ``exit_code`` is not None.
    """

    def __init__(self, engine, conn, *, replica_index: int = 0,
                 clock=time.monotonic, sleep=time.sleep,
                 heartbeat_interval_s: float = 0.05,
                 shed_percentile: float = 50.0,
                 digest_limit: int = DIGEST_SUMMARY_LIMIT,
                 telemetry=NULL_TELEMETRY, fault=None, exit_hook=None,
                 spill_store: str | None = None,
                 spill_checkpoint_every_s: float = 0.0):
        self.engine = engine
        self.conn = conn
        self.index = int(replica_index)
        self.clock = clock
        self.sleep = sleep
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.shed_percentile = float(shed_percentile)
        self.digest_limit = int(digest_limit)
        self.telemetry = telemetry
        self.exit_code: int | None = None
        self._exit_when_idle: int | None = None
        self._decoder = net.FrameDecoder()
        self._last_hb_s: float | None = None
        self._hb_seq = 0
        self.last_ack_seq = -1
        # Lifecycle dedup keyed by (request_id, epoch): a retried
        # request is a NEW attempt and gets fresh admitted/result frames
        # stamped with its epoch (the router discards mismatches).
        self._admit_sent: set[tuple[int, int]] = set()
        self._result_sent: set[tuple[int, int]] = set()
        self._epochs: dict[int, int] = {}
        self._poll_cursor: dict[int, int] = {}
        self._peer_gone = False
        # One-shot injected fault (``armed_fault``): fired from pump()
        # once ``_steps_done`` reaches the spec's step. ``exit_hook`` is
        # injectable so in-process tests observe worker_crash without
        # losing the interpreter.
        self.fault = tuple(fault) if fault else None
        self.exit_hook = exit_hook if exit_hook is not None else os._exit
        self.hung = False
        self.hb_stalled = False
        self._steps_done = 0
        # Spill-tier persistence (engine.save_spill_store): periodic at
        # ``spill_checkpoint_every_s`` + forced on clean drain. The file
        # is what a RESTARTED worker re-warms from.
        self.spill_store = spill_store
        self.spill_checkpoint_every_s = float(spill_checkpoint_every_s)
        self._last_ckpt_s: float | None = None
        self.spill_checkpoints = 0

    # -- outbound ---------------------------------------------------------

    def _send(self, obj: dict) -> None:
        if self._peer_gone:
            return
        try:
            net.send_frame(self.conn, obj)
        except (OSError, net.ProtocolError):
            # Router hung up mid-push: frames become best-effort; the
            # pump loop converts this into the drain-and-exit path.
            self._peer_gone = True

    def _send_kv(self, meta: dict, body: bytes) -> None:
        if self._peer_gone:
            return
        try:
            net.send_kv_frame(self.conn, meta, body)
        except (OSError, net.ProtocolError):
            self._peer_gone = True

    def start(self) -> None:
        """Hello handshake + first heartbeat (the router blocks on the
        hello to learn block_size/slots before any dispatch)."""
        self._send({
            "type": "hello",
            "replica": self.index,
            "role": self.engine.role,
            "block_size": self.engine.block_size,
            "slots": self.engine.slots_n,
            "num_compiles": self.engine.num_compiles,
            "pid": os.getpid(),
        })
        self.heartbeat(force=True)

    def _hist_pct(self, name: str) -> float:
        h = self.telemetry.hists.get(name)
        if h is None or not h.count:
            return 0.0
        return h.percentile(self.shed_percentile) or 0.0

    def heartbeat(self, force: bool = False) -> bool:
        """Push gauges + digest summary + shed-estimate percentiles when
        ``heartbeat_interval_s`` has elapsed (or ``force``)."""
        if self.hb_stalled:
            return False
        now = self.clock()
        if (not force and self._last_hb_s is not None
                and now - self._last_hb_s < self.heartbeat_interval_s):
            return False
        self._last_hb_s = now
        self._hb_seq += 1
        self._send({
            "type": "heartbeat",
            "seq": self._hb_seq,
            "t_s": now,
            "gauges": _jsonable(self.engine.scheduler.gauges(now)),
            "digests": net.digests_to_wire(
                self.engine.prefix_digest_summary(self.digest_limit)
            ),
            "num_compiles": self.engine.num_compiles,
            "est_queue_wait_s": self._hist_pct("queue_wait"),
            "est_prefill_s": self._hist_pct("prefill"),
        })
        return True

    def _sync_lifecycle(self) -> None:
        """Push ``admitted`` / ``result`` frames for lifecycle edges
        since the last sync. Dropped (deadline-expired) requests push a
        result frame too — the router's ledger must resolve every
        submitted id or the fleet never reads idle."""
        for state in self.engine.scheduler.active:
            rid = int(state.request.request_id)
            epoch = self._epochs.get(rid, 0)
            if (rid, epoch) not in self._admit_sent:
                self._admit_sent.add((rid, epoch))
                self._send({"type": "admitted", "request_id": rid,
                            "epoch": epoch, "t_s": state.admit_s})
        for state in list(self.engine.scheduler.finished) + list(
                self.engine.scheduler.dropped):
            rid = int(state.request.request_id)
            epoch = self._epochs.get(rid, 0)
            if (rid, epoch) not in self._result_sent:
                self._result_sent.add((rid, epoch))
                self._send({"type": "result", "request_id": rid,
                            "epoch": epoch,
                            "state": state_to_wire(state)})

    def _push_handoffs(self) -> None:
        """Frame out every queued prefill→decode handoff (engine role
        'prefill'): each becomes one or more binary KV frames to the
        ROUTER — the worker never learns fleet membership; the router
        picks the decode target by digest affinity and forwards. Chains
        longer than ``serving.handoff_blocks_per_frame`` split into
        in-order parts on the same socket; each part is independently
        adoptable (its leading blocks are resident once the previous
        part landed) and only the LAST part triggers the decode-side
        submit, so no part ever nears the 16MB frame cap. A handed-off
        request gets NO result frame from this worker — the KV frame
        itself moves the router's ledger to the decode replica."""
        for h in self.engine.take_handoffs():
            req, state = h["request"], h["state"]
            rid = int(req.request_id)
            epoch = self._epochs.get(rid, 0)
            payloads = h["payloads"]
            per = max(1, int(getattr(
                self.engine.cfg, "handoff_blocks_per_frame", 64
            )))
            parts = max(1, -(-len(payloads) // per))
            digests_hex = net.digests_to_wire(h["digests"])
            for i in range(parts):
                chunk = payloads[i * per:(i + 1) * per]
                self._send_kv({
                    "op": "handoff",
                    "request_id": rid,
                    "epoch": epoch,
                    "part": i,
                    "parts": parts,
                    "last": i == parts - 1,
                    "offset": i * per,
                    "request": _request_to_wire(req),
                    "arrival_s": state.arrival_s,
                    "digests": digests_hex,
                    "sizes": [len(p) for p in chunk],
                    "codec": {
                        "kv_quant": self.engine.kv_quant,
                        "block_bytes": self.engine.block_bytes,
                        "block_size": self.engine.block_size,
                    },
                }, b"".join(chunk))

    def _handle_kv(self, frame: net.KVFrame) -> None:
        """An ``adopt`` KV frame from the router: scatter the shipped
        blocks into the local pool/trie, and on the chain's LAST part
        submit the request — it then admits as a (near-)full prefix
        hit. Adoption failures (stale slice, layout mismatch, full
        pool) degrade to a cold prefill: the submit still happens, so
        correctness never depends on the transfer."""
        meta = frame.meta
        if meta.get("op") != "adopt":
            self._send({
                "type": "error",
                "error": f"unexpected kv frame op {meta.get('op')!r}",
            })
            return
        rid = int(meta["request_id"])
        request = request_from_wire(meta["request"])
        try:
            self.engine.adopt_chain(
                list(request.prompt), frame.blocks(),
                offset=int(meta.get("offset", 0)),
            )
        except ValueError:
            # Layout/overrun mismatch: the blocks are unusable here but
            # the request is not — cold prefill covers it.
            self.engine.handoff_stats["adopt_fallbacks"] += 1
        if meta.get("last", True):
            self._epochs[rid] = int(meta.get("epoch", 0))
            try:
                # scheduler-level submit, like a reroute: the fleet
                # front door already accepted this request on the
                # prefill side.
                self.engine.scheduler.submit(
                    request, float(meta.get("arrival_s", self.clock()))
                )
            except Exception as exc:  # noqa: BLE001 — report, don't die
                self._send({
                    "type": "submit_error",
                    "request_id": rid,
                    "error": f"{type(exc).__name__}: {exc}",
                })

    # -- inbound ----------------------------------------------------------

    def handle(self, msg) -> None:
        if isinstance(msg, net.KVFrame):
            self._handle_kv(msg)
            return
        op = msg.get("op")
        if op == "submit":
            request = request_from_wire(msg["request"])
            if request.request_id is not None:
                self._epochs[int(request.request_id)] = int(
                    msg.get("epoch", 0)
                )
            try:
                if msg.get("reroute"):
                    # Quarantine-displaced work the router already
                    # accepted: straight into the scheduler, bypassing
                    # the draining front-door check (mirrors the
                    # in-process Replica.reroute_in).
                    self.engine.scheduler.submit(
                        request, float(msg.get("arrival_s", self.clock()))
                    )
                else:
                    self.engine.submit(
                        request, float(msg.get("arrival_s", self.clock()))
                    )
            except Exception as exc:  # noqa: BLE001 — report, don't die
                self._send({
                    "type": "submit_error",
                    "request_id": request.request_id,
                    "error": f"{type(exc).__name__}: {exc}",
                })
        elif op == "poll":
            deltas = {}
            for state in self.engine.scheduler.active:
                rid = int(state.request.request_id)
                seen = self._poll_cursor.get(rid, 0)
                fresh = state.generated[seen:]
                if fresh:
                    deltas[rid] = [int(t) for t in fresh]
                    self._poll_cursor[rid] = seen + len(fresh)
            self._send({
                "type": "poll_reply",
                "deltas": deltas,
                "gauges": _jsonable(
                    self.engine.scheduler.gauges(self.clock())
                ),
            })
        elif op == "drain":
            self.engine.drain()
            self._send({"type": "drained"})
        elif op == "shutdown":
            self.engine.drain()
            self._exit_when_idle = 0
        elif op == "heartbeat_ack":
            self.last_ack_seq = int(msg.get("seq", -1))
        else:
            self._send({
                "type": "error",
                "error": f"unknown op {op!r}",
            })

    def on_sigterm(self) -> None:
        """The preemption contract: cut intake, finish in-flight work,
        then exit ``EXIT_PREEMPTED`` (handled in :meth:`pump` once the
        engine drains idle and every result frame is pushed)."""
        if not self.engine.draining:
            self.engine.drain()
        self._exit_when_idle = EXIT_PREEMPTED

    # -- fault injection (serving.fault_injection; chaos harness) ---------

    def _maybe_fault(self) -> None:
        """Fire the armed one-shot fault once the engine has run the
        spec's step count. worker_crash exits hard (no drain, no flush —
        that is the point); worker_hang freezes the loop with the
        process alive (the stale-heartbeat detection target); conn_drop
        severs the router socket (the EOF/RST detection target);
        heartbeat_stall keeps SERVING while going silent — the half-dead
        worker whose late result frames the epoch check discards."""
        if self.fault is None:
            return
        kind, step = self.fault
        if self._steps_done < step:
            return
        self.fault = None
        print(json.dumps({
            "event": "fault_injected", "kind": kind,
            "replica": self.index, "step": self._steps_done,
        }), flush=True)
        if kind == "worker_crash":
            self.exit_hook(EXIT_FAULT)
        elif kind == "worker_hang":
            self.hung = True
        elif kind == "conn_drop":
            try:
                self.conn.close()
            except OSError:
                pass
        elif kind == "heartbeat_stall":
            self.hb_stalled = True

    # -- spill-tier persistence -------------------------------------------

    def checkpoint_spill(self, force: bool = False) -> bool:
        """Persist the engine's host spill tier to ``spill_store`` when
        the periodic cadence has elapsed (or ``force``, the clean-drain
        path). A crash skips this by definition — the LAST periodic file
        is what the restarted worker re-warms from."""
        if not self.spill_store or not getattr(
                self.engine, "spill_blocks", 0):
            return False
        now = self.clock()
        if not force:
            if not self.spill_checkpoint_every_s:
                return False
            if (self._last_ckpt_s is not None
                    and now - self._last_ckpt_s
                    < self.spill_checkpoint_every_s):
                return False
        self._last_ckpt_s = now
        self.engine.save_spill_store(self.spill_store)
        self.spill_checkpoints += 1
        return True

    # -- the loop body ----------------------------------------------------

    def pump(self) -> bool:
        """One serve-loop iteration: drain readable frames, step the
        engine if it has work, push lifecycle frames + heartbeat, and
        settle the exit once draining completes. Returns True while
        anything moved (the caller selects on the socket when False)."""
        if self.exit_code is not None:
            return False
        self._maybe_fault()
        if self.hung:
            # Wedged: no reads, no steps, no heartbeats — the process
            # stays alive until the supervisor's stale-heartbeat kill.
            return False
        busy = False
        try:
            frames = net.recv_available(self.conn, self._decoder)
        except OSError:
            self._peer_gone = True
            frames = None
        if self._peer_gone:
            frames = None
        if frames is None:
            # Router hung up without a shutdown op: treat as shutdown —
            # finish accepted work, flush, exit clean.
            if self._exit_when_idle is None:
                self.engine.drain()
                self._exit_when_idle = 0
            frames = []
        for msg in frames:
            busy = True
            self.handle(msg)
        if not self.engine.scheduler.idle:
            busy = self.engine.step() or busy
            self._steps_done += 1
            self._sync_lifecycle()
            self._push_handoffs()
        self.heartbeat()
        self.checkpoint_spill()
        if (self._exit_when_idle is not None
                and self.engine.scheduler.idle):
            self._finish(self._exit_when_idle)
        return busy

    def _finish(self, code: int) -> None:
        self._sync_lifecycle()
        self._push_handoffs()
        self.checkpoint_spill(force=True)
        try:
            self._send({
                "type": "goodbye",
                "exit": code,
                "spill_checkpoints": self.spill_checkpoints,
                "stats": _jsonable(self.engine.stats()),
            })
        except (OSError, net.ProtocolError):
            pass
        self.telemetry.write_trace()
        self.exit_code = code


def _jsonable(obj):
    """Best-effort JSON coercion for gauges/stats payloads (numpy
    scalars, tuples, nested dicts)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)


def serve_forever(worker: ReplicaWorker, *,
                  io_wait_s: float = 0.002) -> int:
    """Drive ``worker.pump()`` to completion, selecting on the socket
    while idle so an empty worker costs ~no CPU."""
    while worker.exit_code is None:
        busy = worker.pump()
        if worker.exit_code is not None:
            break
        if worker.hung:
            # No reads, no work — just stay alive (and cheap) until the
            # supervisor kills the process.
            worker.sleep(0.05)
            continue
        if not busy and worker.engine.scheduler.idle:
            timeout = io_wait_s
            if worker.heartbeat_interval_s:
                timeout = min(io_wait_s * 25, worker.heartbeat_interval_s)
            try:
                select.select([worker.conn], [], [], timeout)
            except OSError:
                pass
    return worker.exit_code


# ---------------------------------------------------------------------------
# process entry point
# ---------------------------------------------------------------------------


def _build_from_spec(spec: dict, *, seed: int):
    """Bench/test boot: build the model from an inline spec dict (no
    config file, no checkpoint) with weights drawn from ``seed`` (the
    port's init, ``init_weights`` on a seeded generator) — every worker
    AND the parity oracle build identical state."""
    import torch

    from .. import models
    from ..config import ServingConfig

    mspec = spec.get("model", {})
    model = models.get_model(
        mspec.get("name", "gpt2"), **mspec.get("kwargs", {})
    )
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    scfg = ServingConfig(**{
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in spec.get("serving", {}).items()
    })
    return model, scfg


def _build_from_config(config_path: str, overrides: list[str], device):
    """CLI boot: the build and restore path ``cli serve`` runs for a
    single engine (the model from ``train.seed``, the latest checkpoint
    of ``train.checkpoint_dir`` when it holds one), minus the router tier
    (this process IS one replica)."""
    from ..cli import _restore_or_init, build_model
    from ..config import apply_overrides, load_config
    from ..train import TrainState
    from .engine import check_serving_composition

    cfg = apply_overrides(load_config(config_path), overrides)
    check_serving_composition(cfg, fleet=1)
    vocab = cfg.model.kwargs.get("vocab_size", 50257)
    if vocab != 256:
        raise ValueError(
            f"cli serve requires a byte-tokenizer model (vocab_size=256, "
            f"got {vocab})"
        )
    model = build_model(cfg, device)
    _restore_or_init(
        cfg, TrainState(step=0, params=dict(model.named_parameters()),
                        opt_state=None, rng=int(cfg.train.seed)),
        "serving from")
    return model, cfg.serving


def _run_oracle(spec: dict, seed: int, device) -> int:
    """``--oracle``: a direct single-engine run over the request list on
    stdin — the greedy-parity reference, executed in the same process
    environment as the workers."""
    from .engine import ServingEngine
    from .scheduler import Request

    model, scfg = _build_from_spec(spec, seed=seed)
    engine = ServingEngine(model, scfg, seed=seed, device=device)
    payload = json.loads(sys.stdin.read())
    for d in payload["requests"]:
        engine.submit(Request(
            prompt=[int(t) for t in d["prompt"]],
            max_new_tokens=int(d["max_new_tokens"]),
            request_id=int(d["request_id"]),
        ))
    finished = engine.run()
    print(json.dumps({
        "event": "oracle_result",
        "results": {
            str(s.request.request_id): [int(t) for t in s.generated]
            for s in finished
        },
        "num_compiles": engine.num_compiles,
    }), flush=True)
    return 0


def report_launches(engine, replica_index: int, attempt: int) -> dict:
    """Sync the device and print the ``worker_launches`` line: this
    process's decode calls and the paged kernels' launches (each wrapper
    counts its own launches), so a caller holds launches against decode
    calls x layers worker by worker, and its engine's ``handoff_stats``,
    so a caller sees how many shipped KV blocks a decode worker adopted
    and whether any adoption fell back to a cold prefill. Returns the
    record."""
    import torch

    from ..ops import paged_attention

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    rec = {
        "event": "worker_launches",
        "replica": int(replica_index),
        "attempt": int(attempt),
        "role": engine.role,
        "device": str(engine.device),
        "layers": int(engine.model.num_layers),
        "calls": dict(engine.calls),
        "launches": dict(paged_attention.LAUNCHES),
        "handoff": dict(engine.handoff_stats),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="distributeddeeplearning_tpu_torch.serving.worker"
    )
    p.add_argument("--config", help="config .py (cli serve boot path)")
    p.add_argument("--override", action="append", default=[],
                   metavar="a.b=v")
    p.add_argument("--spec-json", help="inline JSON spec (bench/test "
                   "boot: model kwargs + serving kwargs, weights drawn "
                   "from --seed, no checkpoint)")
    p.add_argument("--replica-index", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = bind an ephemeral port (reported in the "
                   "worker_ready line)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default: cuda; "
                   "'cpu' on request)")
    p.add_argument("--telemetry-dir", default=None)
    p.add_argument("--spill-store", default=None,
                   help="spill-tier persistence file: loaded on boot if "
                   "it exists (the restart re-warm), written on the "
                   "serving.spill_checkpoint_every_s cadence + on clean "
                   "drain")
    p.add_argument("--oracle", action="store_true",
                   help="no socket: run the stdin request list on one "
                   "engine directly and print the token map (the fleet "
                   "bench's parity reference)")
    args = p.parse_args(argv)

    if bool(args.config) == bool(args.spec_json):
        p.error("exactly one of --config / --spec-json is required")

    if args.oracle:
        if not args.spec_json:
            p.error("--oracle requires --spec-json")
        return _run_oracle(json.loads(args.spec_json), args.seed,
                           args.device)

    from .. import resolve_device

    device = resolve_device(args.device)  # no CUDA: an error, not the CPU
    if args.spec_json:
        model, scfg = _build_from_spec(
            json.loads(args.spec_json), seed=args.seed
        )
    else:
        model, scfg = _build_from_config(
            args.config, args.override, device
        )
    check_fleet_composition(scfg, max(1, args.replica_index + 1))

    from ..telemetry import Telemetry
    from .engine import ServingEngine

    tel = (
        Telemetry(enabled=True, out_dir=args.telemetry_dir,
                  process_index=args.replica_index)
        if args.telemetry_dir else NULL_TELEMETRY
    )
    engine = ServingEngine(model, scfg, seed=args.seed, telemetry=tel,
                           device=device)
    engine.warmup()
    rewarm_chains = 0
    if args.spill_store and os.path.exists(args.spill_store):
        # The restart re-warm: adopt the previous attempt's persisted
        # host tier so this worker rejoins with its prefix cache warm.
        rewarm_chains = engine.load_spill_store(args.spill_store)
    attempt = int(os.environ.get(ATTEMPT_ENV) or 0)

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind((args.host, args.port))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    print(json.dumps({
        "event": "worker_ready",
        "replica": args.replica_index,
        "role": engine.role,
        "host": args.host,
        "port": port,
        "pid": os.getpid(),
        "attempt": attempt,
        "spill_rewarm_chains": rewarm_chains,
        "num_compiles": engine.num_compiles,
    }), flush=True)

    # SIGTERM before accept: nothing in flight — flush and exit the
    # preemption code immediately.
    preempted_early = []
    signal.signal(
        signal.SIGTERM, lambda *_: preempted_early.append(True)
    )
    lsock.settimeout(0.25)
    conn = None
    deadline = time.monotonic() + 120.0
    while conn is None:
        if preempted_early:
            tel.write_trace()
            report_launches(engine, args.replica_index, attempt)
            return EXIT_PREEMPTED
        if time.monotonic() > deadline:
            print(json.dumps({
                "event": "worker_timeout",
                "error": "no router connection within 120s",
            }), file=sys.stderr, flush=True)
            tel.write_trace()
            return 1
        try:
            conn, _ = lsock.accept()
        except socket.timeout:
            continue
    lsock.close()
    conn.setblocking(False)

    worker = ReplicaWorker(
        engine, conn,
        replica_index=args.replica_index,
        heartbeat_interval_s=scfg.heartbeat_interval_s,
        shed_percentile=scfg.shed_percentile,
        telemetry=tel,
        fault=armed_fault(scfg, args.replica_index),
        spill_store=args.spill_store,
        spill_checkpoint_every_s=getattr(
            scfg, "spill_checkpoint_every_s", 0.0
        ),
    )
    signal.signal(signal.SIGTERM, lambda *_: worker.on_sigterm())
    worker.start()
    code = serve_forever(worker)
    conn.close()
    report_launches(engine, args.replica_index, attempt)
    return code


if __name__ == "__main__":
    sys.exit(main())
