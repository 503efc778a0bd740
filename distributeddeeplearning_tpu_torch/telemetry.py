"""Unified telemetry: span tracer, goodput ledger, device registry,
flight recorder (``TelemetryConfig``).

The port's own copy of the JAX package's ``telemetry.py`` (standard
library only, so it runs unchanged here; ``tests/test_torch_telemetry.py``
holds the two against each other):

- :class:`SpanTracer` — hierarchical host-side spans (``step`` /
  ``data_wait`` / ``dispatch`` / ``device_wait`` / ``checkpoint`` /
  ``eval`` and the serving phases ``prefill`` / ``decode`` /
  ``schedule``) in a bounded ring with strictly monotonic timestamps,
  nestable via context manager, near-zero cost when disabled, exportable
  as Chrome-trace/Perfetto JSON (matched B/E pairs) or a JSONL stream on
  the ``metrics.event_record`` shape.
- :class:`GoodputLedger` — wall-clock decomposed into productive step
  time vs. compile / data wait / checkpoint stalls / eval /
  rollback-replayed steps / restart backoff, persisted across restarts as
  an attempt-stamped JSONL sidecar; :func:`summarize_goodput` folds every
  attempt and the backoff records into one ``goodput_fraction``.
- :class:`DeviceRegistry` — per-program records: first-call (build) wall
  time, a memory analysis where the program object reports one, and
  recompile counters; the serving engine registers its prefill, decode
  and verify programs here.
- :func:`dump_flight` — the crash flight recorder: the last N spans and
  events dumped to a file beside the run's other artifacts.

This module imports nothing outside the standard library.

Everything here is best-effort at the EDGES: recording is exact, but
disk writes never raise — telemetry must not be the thing that takes a
run down.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import time
from collections import deque

# The span taxonomy. Advisory, not enforced:
# callers may open spans with other names, but the standard loop/serving
# phases use exactly these so traces compare across runs.
SPAN_NAMES = (
    "step", "data_wait", "dispatch", "device_wait", "checkpoint", "eval",
    "prefill", "decode", "schedule",
)

# Speculative-decoding accept counter (serving/engine.py): tokens
# emitted per lane per verify step (1 = all drafts rejected, K+1 = all
# accepted) recorded into a standard LatencyHistogram — the value is a
# COUNT, not seconds, but the log-bucket encoding holds small integers
# exactly enough and, unlike a bespoke counter, it merges across fleet
# processes through the same stats_dict()/aggregate path as every
# latency SLO, so `cli report` sees fleet-wide accept distributions for
# free. summary()["mean_s"] is the mean accepted-per-step.
SPEC_ACCEPT_HIST = "spec_accept"

# Goodput ledger categories. "other" is the computed residual at attempt
# close, so every attempt record's categories sum exactly to its wall.
GOODPUT_CATEGORIES = (
    "productive_step", "rollback_replay", "compile", "data_wait",
    "checkpoint_stall", "eval", "restart_backoff", "other",
)


def stamped(base: str, process_index: int, attempt: int | None = None) -> str:
    """Per-process (and optionally per-attempt) artifact name:
    ``trace.json`` -> ``trace_p3_a1.json``. N ``cli launch`` children can
    then share one telemetry dir without clobbering each other, and the
    fleet aggregator (``telemetry_aggregate.py``) can attribute every
    artifact back to its (process, attempt)."""
    root, ext = os.path.splitext(base)
    name = f"{root}_p{int(process_index)}"
    if attempt is not None:
        name += f"_a{int(attempt)}"
    return name + ext


# ---------------------------------------------------------------------------
# streaming latency histogram
# ---------------------------------------------------------------------------


class LatencyHistogram:
    """Fixed-size log-bucketed streaming histogram over seconds.

    The SLO-grade percentile sketch: ``n`` buckets geometrically spaced
    over ``[lo, hi)`` (out-of-range samples clamp into the edge buckets),
    so memory is O(n) regardless of sample count. Two invariants the
    tests pin:

    - **exact count**: ``sum(counts) == count`` always — a recorded
      sample is never lost to rounding;
    - **merge == union**: merging two histograms (same layout) is
      elementwise count addition, so a fleet-level histogram merged from
      N processes equals the histogram of the concatenated samples —
      percentiles aggregate across processes without shipping samples.

    ``percentile(q)`` returns the geometric midpoint of the bucket
    holding the ceil-rank order statistic, clamped to the observed
    min/max — within one bucket's relative width (:attr:`rel_error`,
    ~8.4% at the default layout) of the exact order statistic for any
    in-range sample."""

    __slots__ = ("lo", "hi", "n", "_log_lo", "_log_g", "counts", "count",
                 "sum", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1000.0, n: int = 256):
        if not (0.0 < lo < hi) or n < 2:
            raise ValueError(f"bad histogram layout lo={lo} hi={hi} n={n}")
        self.lo, self.hi, self.n = float(lo), float(hi), int(n)
        self._log_lo = math.log(self.lo)
        self._log_g = (math.log(self.hi) - self._log_lo) / self.n
        self.counts = [0] * self.n
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    @property
    def rel_error(self) -> float:
        """One bucket's relative width (the percentile error bound)."""
        return math.exp(self._log_g) - 1.0

    def layout(self) -> tuple[float, float, int]:
        return (self.lo, self.hi, self.n)

    def record(self, seconds: float) -> None:
        x = float(seconds)
        self.count += 1
        self.sum += x
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x
        if x < self.lo:
            i = 0
        elif x >= self.hi:
            i = self.n - 1
        else:
            i = min(int((math.log(x) - self._log_lo) / self._log_g),
                    self.n - 1)
        self.counts[i] += 1

    def percentile(self, q: float) -> float | None:
        """The q-th percentile (0..100) as the geometric midpoint of the
        bucket containing the ceil-rank order statistic; None when
        empty."""
        if not self.count:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                mid = math.exp(self._log_lo + (i + 0.5) * self._log_g)
                return min(max(mid, self.min), self.max)
        return self.max  # unreachable while the exact-count invariant holds

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """In-place merge (identical layouts only). Merge-equals-union is
        what makes per-process histograms a fleet primitive."""
        if self.layout() != other.layout():
            raise ValueError(
                f"histogram layout mismatch: {self.layout()} vs "
                f"{other.layout()} — merge requires identical buckets"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max
        return self

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "lo": self.lo,
            "hi": self.hi,
            "n": self.n,
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": self.min,
            "max": self.max,
            # Sparse encoding: most of the 256 buckets are empty.
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, rec: dict) -> "LatencyHistogram":
        h = cls(lo=rec["lo"], hi=rec["hi"], n=rec["n"])
        for i, c in (rec.get("buckets") or {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(rec.get("count", sum(h.counts)))
        h.sum = float(rec.get("sum", 0.0))
        h.min = rec.get("min")
        h.max = rec.get("max")
        return h

    def summary(self) -> dict:
        """The report-facing digest (FLEET.json / BENCH_SERVING.json)."""
        return {
            "count": self.count,
            "p50_s": _round6(self.percentile(50)),
            "p99_s": _round6(self.percentile(99)),
            "mean_s": _round6(self.sum / self.count) if self.count else None,
            "min_s": _round6(self.min),
            "max_s": _round6(self.max),
            "rel_error": round(self.rel_error, 6),
        }


def _round6(v):
    return None if v is None else round(v, 6)


class _NullHistogram:
    """Disabled-telemetry histogram: one shared instance, records nothing."""

    __slots__ = ()
    count = 0

    def record(self, seconds: float) -> None:
        pass


NULL_HISTOGRAM = _NullHistogram()


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    t_start: float  # tracer-clock seconds, strictly monotonic per tracer
    t_end: float
    depth: int  # nesting depth at open (0 = top level)
    args: dict


class _NullSpan:
    """The disabled-tracer context manager: one shared instance, no state,
    so ``tracer.span(...)`` on a disabled tracer allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _SpanCM:
    __slots__ = ("_tracer", "_name", "_args", "_start")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        tr = self._tracer
        tr._stack.append(self._name)
        self._start = tr._now()
        return self

    def set(self, **args) -> None:
        """Attach args discovered INSIDE the span (e.g. the request ids a
        ``schedule`` span admitted) — they land on the span's B event."""
        self._args.update(args)

    def __exit__(self, *exc):
        tr = self._tracer
        end = tr._now()
        tr._stack.pop()
        span = Span(self._name, self._start, end, len(tr._stack), self._args)
        tr._ring.append(span)
        cb = tr.on_close
        if cb is not None:
            cb(span)
        return False


class SpanTracer:
    """Bounded-ring hierarchical span recorder.

    ``with tracer.span("step", step=i): ...`` — spans nest (a context
    manager per level); completed spans land in a ``deque(maxlen=
    ring_size)``, so memory is bounded and the ring always holds the most
    recent history (what the flight recorder wants). Timestamps come from
    an injectable monotonic clock and are FENCED strictly increasing per
    tracer, which is what makes the Chrome-trace export's B/E stream
    well-formed by construction: sorting events by timestamp reproduces
    the exact chronological open/close order, and dropping a ring-evicted
    span removes a matched, properly-nested B/E pair.

    Disabled tracers return a shared no-op context manager: the per-span
    cost is one attribute check, no allocation, no clock read.
    """

    def __init__(self, enabled: bool = True, ring_size: int = 4096,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self._clock = clock
        self._ring: deque[Span] = deque(maxlen=int(ring_size))
        self._stack: list[str] = []
        self._last = 0.0
        # Optional callable(Span) fired at every span close — how the
        # Telemetry bundle feeds per-phase latency histograms without the
        # instrumented code changing (still one attribute check when unset).
        self.on_close = None

    def _now(self) -> float:
        t = self._clock()
        if t <= self._last:
            t = self._last + 1e-9
        self._last = t
        return t

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return _SpanCM(self, name, args)

    @property
    def spans(self) -> list[Span]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    # -- exports ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON: one B and one E event per completed
        span, microsecond timestamps relative to the oldest ringed span,
        strictly increasing (rounding collisions are bumped by 1us so the
        stream stays well-formed after integer truncation). Top-level
        ``t0_s`` is the tracer-clock zero of the ts axis — what the fleet
        aggregator pairs with the process's wall-clock anchor record to
        place N hosts' traces on one timeline."""
        events = []
        for s in self._ring:
            events.append((s.t_start, "B", s))
            events.append((s.t_end, "E", s))
        events.sort(key=lambda e: e[0])
        t0 = events[0][0] if events else 0.0
        pid = os.getpid()
        out = []
        prev_us = -1
        for t, ph, s in events:
            us = int(round((t - t0) * 1e6))
            if us <= prev_us:
                us = prev_us + 1
            prev_us = us
            ev = {"name": s.name, "ph": ph, "ts": us, "pid": pid, "tid": 1,
                  "cat": "host"}
            if ph == "B" and s.args:
                ev["args"] = dict(s.args)
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "t0_s": round(t0, 9)}

    def write_chrome_trace(self, path: str) -> str | None:
        return _write_json(path, self.chrome_trace())

    def to_event_records(self) -> list[dict]:
        """The ringed spans as ``metrics.event_record``-shaped dicts — the
        JSONL stream form (and what the flight recorder embeds)."""
        out = []
        for s in self._ring:
            step = s.args.get("step", -1)
            rec = {
                "event": "span",
                "step": int(step) if isinstance(step, (int, float)) else -1,
                "span": s.name,
                "depth": s.depth,
                "t_s": round(s.t_start, 6),
                "dur_ms": round((s.t_end - s.t_start) * 1e3, 4),
            }
            extra = {k: v for k, v in s.args.items() if k != "step"}
            if extra:
                rec.update(extra)
            out.append(rec)
        return out

    def write_jsonl(self, path: str) -> str | None:
        try:
            with open(path, "w") as f:
                for rec in self.to_event_records():
                    f.write(json.dumps(rec) + "\n")
            return path
        except OSError:
            return None


def validate_chrome_trace(trace) -> list[str]:
    """Structural validation of a Chrome-trace dict: returns a list of
    problems (empty == valid). Checks: traceEvents list, non-decreasing
    timestamps, and that B/E events pair up under stack discipline —
    per ``(pid, tid)`` track, so a fleet-merged trace (one pid per
    process, interleaved timestamps) validates exactly like a
    single-process one. ``M`` metadata events (process/thread names) are
    structural no-ops."""
    problems: list[str] = []
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ):
        return ["no traceEvents list"]
    prev_ts = None
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            problems.append(f"event {i}: missing ph/ts")
            continue
        if ev["ph"] == "M":
            continue  # metadata carries no duration semantics
        if "ts" not in ev:
            problems.append(f"event {i}: missing ph/ts")
            continue
        ts = ev["ts"]
        if prev_ts is not None and ts < prev_ts:
            problems.append(f"event {i}: ts {ts} < previous {prev_ts}")
        prev_ts = ts
        track = (ev.get("pid"), ev.get("tid"))
        stack = stacks.setdefault(track, [])
        if ev["ph"] == "B":
            stack.append(ev.get("name", ""))
        elif ev["ph"] == "E":
            if not stack:
                problems.append(f"event {i}: E with empty stack")
            elif stack[-1] != ev.get("name", ""):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} does not match open "
                    f"span {stack[-1]!r}"
                )
                stack.pop()
            else:
                stack.pop()
    for track, stack in sorted(stacks.items(), key=lambda kv: str(kv[0])):
        if stack:
            problems.append(f"unclosed spans at end: {stack} (track {track})")
    return problems


# ---------------------------------------------------------------------------
# goodput ledger
# ---------------------------------------------------------------------------


class GoodputLedger:
    """Attempt-stamped goodput accounting, persisted as JSONL appends.

    One ledger instance per process; ``open(start_step)`` /
    ``close(final_step)`` bracket each training attempt (a supervised
    restart is a new process → a new instance; an in-process health
    rollback re-opens the same instance). Appends survive restarts — the
    sidecar is the cross-attempt source of truth, and ``open`` re-reads
    it so replayed steps (resume below a step some earlier attempt
    already reached) are classified ``rollback_replay``, not productive.

    ``clock`` is injectable (fake-clock tests); categories are plain
    ``add(category, seconds)`` buckets except the residual ``other``,
    computed at close so every attempt record sums exactly to its wall.
    """

    def __init__(self, path: str, *, attempt: int = 0, clock=time.monotonic):
        self.path = path
        self.attempt = int(attempt)
        self._clock = clock
        self._t_open: float | None = None
        self._acc: dict[str, float] = {}
        self._run = 0  # in-process open/close cycles (health rollbacks)
        self._start_step = 0
        self._max_step = 0
        self._prior_max = -1
        self._steps = {"productive": 0, "replayed": 0}

    def open(self, start_step: int = 0) -> None:
        self._t_open = self._clock()
        self._acc = {}
        self._start_step = int(start_step)
        self._max_step = int(start_step)
        self._steps = {"productive": 0, "replayed": 0}
        self._prior_max = -1
        for rec in read_goodput(self.path):
            if rec.get("record") == "attempt":
                self._prior_max = max(
                    self._prior_max, int(rec.get("max_step", -1))
                )

    def add(self, category: str, seconds: float) -> None:
        self._acc[category] = self._acc.get(category, 0.0) + float(seconds)

    def step_time(self, seconds: float, end_step: int) -> None:
        """Attribute one step interval's host time: productive when it
        advances past every step a prior attempt already completed,
        rollback-replay otherwise (re-earning lost ground is not
        goodput)."""
        end_step = int(end_step)
        replay = end_step <= self._prior_max
        self.add("rollback_replay" if replay else "productive_step", seconds)
        self._steps["replayed" if replay else "productive"] += 1
        self._max_step = max(self._max_step, end_step)

    def close(self, final_step: int | None = None) -> dict | None:
        if self._t_open is None:
            return None
        wall = self._clock() - self._t_open
        self._t_open = None
        if final_step is not None:
            self._max_step = max(self._max_step, int(final_step))
        cats = {k: round(v, 6) for k, v in self._acc.items()}
        cats["other"] = round(max(wall - sum(self._acc.values()), 0.0), 6)
        rec = {
            "schema": 1,
            "record": "attempt",
            "attempt": self.attempt,
            "run": self._run,
            "wall_s": round(wall, 6),
            "categories": cats,
            "start_step": self._start_step,
            "max_step": self._max_step,
            "steps_productive": self._steps["productive"],
            "steps_replayed": self._steps["replayed"],
        }
        self._run += 1
        _append_jsonl(self.path, rec)
        return rec


def record_backoff(path: str, attempt: int, backoff_s: float) -> None:
    """Supervisor-side ledger append: the backoff sleep before spawning
    ``attempt`` is pure non-goodput wall time the child never sees."""
    _append_jsonl(path, {
        "schema": 1,
        "record": "backoff",
        "attempt": int(attempt),
        "backoff_s": round(float(backoff_s), 6),
    })


def read_goodput(path: str) -> list[dict]:
    """All parseable records in the sidecar (missing file -> []); a
    torn/partial trailing line (crash mid-append) is skipped, not fatal."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def summarize_goodput(path: str) -> dict | None:
    """Fold every attempt + backoff record into the exit summary:
    total wall, per-category decomposition, and ``goodput_fraction`` =
    productive step time / total wall. None when the sidecar is absent
    or empty (no telemetry ran — absence must be visible, not zeroed)."""
    records = read_goodput(path)
    if not records:
        return None
    total = 0.0
    cats: dict[str, float] = {}
    attempts = 0
    steps_productive = 0
    steps_replayed = 0
    for rec in records:
        if rec.get("record") == "attempt":
            attempts += 1
            total += float(rec.get("wall_s", 0.0))
            steps_productive += int(rec.get("steps_productive", 0))
            steps_replayed += int(rec.get("steps_replayed", 0))
            for k, v in (rec.get("categories") or {}).items():
                cats[k] = cats.get(k, 0.0) + float(v)
        elif rec.get("record") == "backoff":
            b = float(rec.get("backoff_s", 0.0))
            total += b
            cats["restart_backoff"] = cats.get("restart_backoff", 0.0) + b
    if total <= 0.0:
        return None
    return {
        "wall_s": round(total, 6),
        "categories": {k: round(v, 6) for k, v in sorted(cats.items())},
        "goodput_fraction": round(cats.get("productive_step", 0.0) / total, 6),
        "attempts": attempts,
        "steps_productive": steps_productive,
        "steps_replayed": steps_replayed,
    }


# ---------------------------------------------------------------------------
# device registry
# ---------------------------------------------------------------------------


def memory_analysis_dict(compiled) -> dict | None:
    """``compiled.memory_analysis()`` as plain ints, or None where the
    object reports none (guarded: memory telemetry must never be what
    crashes a run)."""
    try:
        ma = compiled.memory_analysis()
        if ma is None:
            return None
        return {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "generated_code_bytes": int(ma.generated_code_size_in_bytes),
            "alias_bytes": int(getattr(ma, "alias_size_in_bytes", 0)),
        }
    except Exception:
        return None


class DeviceRegistry:
    """Per-program build/memory bookkeeping.

    ``record(name, program, compile_s=...)`` is called where a program is
    built or first run (the serving engine registers its prefill widths,
    decode and verify on their first call, ``compile_s`` the seconds of
    that call); a second record under the same name counts as a
    recompile, so steady state shows ``recompiles == 0`` everywhere.
    ``program`` may be any object with a ``memory_analysis()`` method, or
    None."""

    def __init__(self):
        self._entries: dict[str, dict] = {}

    def record(self, name: str, compiled=None, *, compile_s: float | None =
               None, donated_args: int = 0, **extra) -> dict:
        entry = self._entries.get(name)
        if entry is None:
            entry = {
                "name": name,
                "compiles": 0,
                "recompiles": 0,
                "compile_s": 0.0,
                "donated_args": int(donated_args),
                "memory_analysis": None,
            }
            self._entries[name] = entry
        entry["compiles"] += 1
        entry["recompiles"] = entry["compiles"] - 1
        if compile_s is not None:
            entry["compile_s"] = round(entry["compile_s"] + compile_s, 6)
        if donated_args:
            entry["donated_args"] = int(donated_args)
        if compiled is not None:
            ma = memory_analysis_dict(compiled)
            if ma is not None:
                entry["memory_analysis"] = ma
        if extra:
            entry.update(extra)
        return entry

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, name: str) -> dict | None:
        return self._entries.get(name)

    def to_dict(self) -> dict:
        return {"executables": {k: dict(v) for k, v in self._entries.items()}}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def dump_flight(path: str, *, reason: str, tracer: SpanTracer | None = None,
                events=(), last: int = 256, **extra) -> str | None:
    """Write the crash flight record: the last ``last`` spans + events,
    the reason, and any caller context (step, phase, heartbeat, ...).
    Atomic (tmp + replace) and never raises — this runs on the way DOWN
    (fault exits, SIGKILL-imminent hangs); a write failure must not mask
    the original failure."""
    rec = {
        "schema": 1,
        "reason": reason,
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        **extra,
    }
    spans = tracer.to_event_records() if tracer is not None else []
    rec["spans"] = spans[-int(last):]
    rec["events"] = list(events)[-int(last):]
    return _write_json(path, rec)


# ---------------------------------------------------------------------------
# runtime bundle
# ---------------------------------------------------------------------------


def resolve_process_index(env=None) -> int:
    """This process's fleet index, from the environment:
    ``DDL_PROCESS_INDEX`` (exported by ``cli launch`` for every child)
    wins, then ``PROCESS_ID``, else 0 (single process)."""
    env = os.environ if env is None else env
    for var in ("DDL_PROCESS_INDEX", "PROCESS_ID"):
        v = env.get(var, "")
        try:
            return int(v)
        except (TypeError, ValueError):
            continue
    return 0


def resolve_dir(cfg) -> str:
    """The telemetry output dir for a full ``Config``: explicit
    ``telemetry.dir`` wins; else quarantine-adjacent inside
    ``train.checkpoint_dir`` (flight records land next to any
    ``<step>.corrupt`` the checkpoint layer quarantined); else a temp
    fallback so ``--telemetry`` without a checkpoint dir still works."""
    if cfg.telemetry.dir:
        return cfg.telemetry.dir
    if cfg.train.checkpoint_dir:
        return os.path.join(cfg.train.checkpoint_dir, "telemetry")
    return os.path.join(tempfile.gettempdir(), "ddl_telemetry")


class Telemetry:
    """The wired-through bundle: one tracer + ledger + registry + event
    ring, shared by fit / cli / the serving engine.

    A disabled instance (``NULL_TELEMETRY``) is safe to thread
    everywhere: ``span`` returns the shared no-op context manager,
    ``note_event`` / ``record_exe`` / ``flight_dump`` return immediately,
    and ``ledger`` is None — the instrumented loop pays one truthiness
    check per hook.
    """

    # Span names whose durations auto-feed a same-named latency histogram
    # (via the tracer's on_close hook): the per-phase SLO distributions.
    HIST_SPANS = frozenset(SPAN_NAMES)

    def __init__(self, *, enabled: bool = True, out_dir: str | None = None,
                 attempt: int = 0, process_index: int = 0,
                 ring_size: int = 4096,
                 flight_last: int = 256, trace_file: str = "trace.json",
                 goodput_file: str = "goodput.jsonl",
                 span_clock=time.perf_counter, wall_clock=time.monotonic,
                 epoch_clock=time.time):
        self.enabled = bool(enabled) and out_dir is not None
        self.dir = out_dir
        self.attempt = int(attempt)
        self.process_index = int(process_index)
        self.flight_last = int(flight_last)
        self._trace_file = trace_file
        self.tracer = SpanTracer(
            enabled=self.enabled, ring_size=ring_size, clock=span_clock
        )
        self.registry = DeviceRegistry()
        self.events: deque = deque(maxlen=int(flight_last))
        self.ledger = None
        self.hists: dict[str, LatencyHistogram] = {}
        self.counters: dict[str, int] = {}
        self._gauge_last: dict = {}
        self._gauge_max: dict = {}
        self._gauge_samples = 0
        if self.enabled:
            try:
                os.makedirs(out_dir, exist_ok=True)
            except OSError:
                self.enabled = False
                self.tracer.enabled = False
                return
            self.tracer.on_close = self._on_span_close
            self.ledger = GoodputLedger(
                os.path.join(out_dir, stamped(goodput_file, process_index)),
                attempt=attempt, clock=wall_clock,
            )
            # Clock-alignment anchor, written EAGERLY at open (crash-safe):
            # one simultaneous (wall epoch, span clock) reading pairs this
            # process's private monotonic ts axis with shared wall time, so
            # the aggregator can place N hosts' traces on one timeline.
            _write_json(self.anchor_path, {
                "schema": 1,
                "record": "anchor",
                "process_index": self.process_index,
                "attempt": self.attempt,
                "pid": os.getpid(),
                "wall_epoch_s": float(epoch_clock()),
                "span_clock_s": float(self.tracer._clock()),
            })

    @classmethod
    def from_config(cls, cfg, *, attempt: int = 0,
                    process_index: int | None = None) -> "Telemetry":
        """Build from a full ``Config`` (NULL when telemetry is off).

        ``process_index=None`` resolves from the environment —
        ``DDL_PROCESS_INDEX`` (set by ``cli launch`` for every child) or
        the coordinated-mode ``PROCESS_ID`` — so N children sharing one
        telemetry dir stamp their artifacts without the caller having to
        thread an index through (single process ⇒ 0)."""
        t = cfg.telemetry
        if not t.enabled:
            return NULL_TELEMETRY
        if process_index is None:
            process_index = resolve_process_index()
        return cls(
            enabled=True,
            out_dir=resolve_dir(cfg),
            attempt=attempt,
            process_index=process_index,
            ring_size=t.ring_size,
            flight_last=t.flight_last,
            trace_file=t.trace_file,
            goodput_file=t.goodput_file,
        )

    # -- hooks (all no-ops when disabled) -----------------------------------

    def span(self, name: str, **args):
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name, **args)

    def _on_span_close(self, span: Span) -> None:
        if span.name in self.HIST_SPANS:
            self.hist(span.name).record(span.t_end - span.t_start)

    def hist(self, name: str):
        """The named latency histogram (created on first use, fixed
        default layout so every process's histograms merge). Spans named
        in :attr:`HIST_SPANS` feed these automatically; callers record
        derived latencies (``ttft``, queueing delay, ...) explicitly."""
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = LatencyHistogram()
        return h

    def note_gauges(self, gauges: dict) -> None:
        """Record one gauge sample (queue depth, free KV blocks, ...):
        last value + running max per key — the saturation signals the
        fleet report surfaces without storing the time series."""
        if not self.enabled:
            return
        self._gauge_samples += 1
        for k, v in gauges.items():
            self._gauge_last[k] = v
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                prev = self._gauge_max.get(k)
                if prev is None or v > prev:
                    self._gauge_max[k] = v

    def note_event(self, record: dict) -> None:
        """Mirror one emit-stream record into the flight-recorder ring."""
        if self.enabled:
            self.events.append(record)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named monotonic counter (worker_restarts,
        requests_retried, stale_frames, ...) — the resilience tallies the
        fleet report reads from the stats record without replaying the
        event stream."""
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def record_exe(self, name: str, compiled=None, **kw) -> None:
        if self.enabled:
            self.registry.record(name, compiled, **kw)

    def flight_dump(self, reason: str, **extra) -> str | None:
        if not self.enabled:
            return None
        path = os.path.join(
            self.dir,
            f"flight_{reason}_p{self.process_index}"
            f"_attempt{self.attempt}.json",
        )
        return dump_flight(
            path, reason=reason, tracer=self.tracer, events=self.events,
            last=self.flight_last, attempt=self.attempt,
            process_index=self.process_index, **extra,
        )

    def stats_dict(self) -> dict:
        """The mergeable per-process stats record: every latency histogram
        (full bucket encoding — the aggregator re-materializes and merges
        them), the gauge digest, and the executable registry."""
        return {
            "schema": 1,
            "record": "stats",
            "process_index": self.process_index,
            "attempt": self.attempt,
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self.hists.items())},
            "counters": dict(sorted(self.counters.items())),
            "gauges": {
                "samples": self._gauge_samples,
                "last": dict(self._gauge_last),
                "max": dict(self._gauge_max),
            },
            "registry": self.registry.to_dict(),
        }

    def write_trace(self) -> str | None:
        """Write (atomically replace) the Chrome trace + span JSONL + the
        histogram/gauge/registry stats record from the current state.
        Idempotent; called at every attempt boundary so the newest
        artifacts survive whatever happens next."""
        if not self.enabled:
            return None
        self.tracer.write_jsonl(self.spans_path)
        _write_json(self.stats_path, self.stats_dict())
        return self.tracer.write_chrome_trace(self.trace_path)

    def _stamped_path(self, base: str) -> str | None:
        if not self.enabled:
            return None
        return os.path.join(
            self.dir, stamped(base, self.process_index, self.attempt)
        )

    @property
    def trace_path(self) -> str | None:
        return self._stamped_path(self._trace_file)

    @property
    def spans_path(self) -> str | None:
        return self._stamped_path("spans.jsonl")

    @property
    def stats_path(self) -> str | None:
        return self._stamped_path("stats.json")

    @property
    def anchor_path(self) -> str | None:
        return self._stamped_path("anchor.json")


NULL_TELEMETRY = Telemetry(enabled=False, out_dir=None)


# ---------------------------------------------------------------------------
# small io helpers (never raise)
# ---------------------------------------------------------------------------


def _write_json(path: str, obj) -> str | None:
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def _append_jsonl(path: str, rec: dict) -> None:
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
    except OSError:
        pass
