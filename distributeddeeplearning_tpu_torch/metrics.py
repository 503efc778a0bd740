"""Metric-stream records: the training loop's interval records and the
serving engine's lifecycle events and gauges, the same record shapes as the
JAX package's ``metrics`` module so one stream consumer reads both; the
scalar writer (``<log_dir>/metrics.jsonl``) and the step-window profiler of
``cli train``, both on rank 0 only."""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from .mesh import is_rank0


def event_record(name: str, step: int, **fields) -> dict:
    """A loop-status EVENT as a metrics-stream record: ``{"event": name,
    "step": step, ...}``."""
    return {"event": name, "step": step, **fields}


SERVING_EVENTS = (
    "request_admitted", "first_token", "request_completed",
    "request_shed", "request_rerouted", "request_failed",
    "request_retried", "request_handoff",
)


def serving_event(name: str, step: int, *, request_id: int, **fields) -> dict:
    """A serving lifecycle event. ``name`` must be one of
    :data:`SERVING_EVENTS`; the request id is coerced to a plain int so it
    renders as the same JSON token everywhere."""
    if name not in SERVING_EVENTS:
        raise ValueError(
            f"unknown serving event {name!r} (expected one of "
            f"{SERVING_EVENTS})"
        )
    return event_record(name, step, request_id=int(request_id), **fields)


def serving_gauges(step: int, *, pending: int, active: int, free_blocks: int,
                   used_blocks: int, **fields) -> dict:
    """Engine-level gauges (queue depth, pool occupancy) on the event
    record shape, emitted every ``serving.gauge_every`` engine steps."""
    return event_record(
        "serving_gauges", step, pending=int(pending), active=int(active),
        free_blocks=int(free_blocks), used_blocks=int(used_blocks), **fields,
    )


TRAIN_KEYS = ("loss", "perplexity", "step", "wall_s")


def train_record(step: int, metrics: dict, **extras) -> dict:
    """A training interval's record: ``{metric: float, ..., "step": step,
    **extras}`` (``fit`` adds ``wall_s``), for the LM task ``{"loss",
    "perplexity", "step", "wall_s"}``."""
    out = {k: float(v) for k, v in metrics.items()}
    out["step"] = step
    out.update(extras)
    return out


class DeferredMetrics:
    """One-interval-lag metric fetch: the non-blocking logging path.

    ``push(step, metrics)`` starts an asynchronous device-to-host copy of
    the interval's scalars and emits the PREVIOUS interval's record, whose
    copy has had a whole interval to land, so logging never drains the
    device queue. ``flush()`` emits the pending interval.

    Contract: after ``push(n)``, intervals ``1..n-1`` have been emitted and
    ``n`` is pending; ``flush()`` emits it.
    """

    def __init__(self, emit):
        self._emit = emit  # emit(dict)
        self._pending = None  # (step, host metrics, copy event, extras)

    def push(self, step: int, metrics: dict, **extras) -> None:
        host, event = {}, None
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                host[k] = v.detach().to("cpu", non_blocking=True)
                if event is None:
                    event = torch.cuda.Event()
            else:
                host[k] = v
        if event is not None:
            event.record()
        prev, self._pending = self._pending, (step, host, event, extras)
        if prev is not None:
            self._materialize(prev)

    def flush(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._materialize(pending)

    def discard(self) -> None:
        """Drop the pending interval without emitting it."""
        self._pending = None

    def emit_event(self, record: dict) -> None:
        """Emit a loop-status event (:func:`event_record`) in the same
        ordered stream: the pending interval goes first, so an event at
        step N never comes before the records of earlier steps."""
        self.flush()
        self._emit(record)

    def _materialize(self, item) -> None:
        step, host, event, extras = item
        if event is not None:
            event.synchronize()
        self._emit(train_record(step, host, **extras))


class MetricWriter:
    """Scalar writer (rank 0 only); a no-op without a ``logdir``.

    Each ``write`` appends one ``{"schema": 1, "step": N, ...scalars}`` line
    to ``<logdir>/metrics.jsonl`` (``schema`` is the line format's version,
    as the reference's). Disk trouble never stops the run: a directory that
    cannot be made, or a line that cannot be written, is dropped. The
    reference's second sink, TensorBoard summaries, is not ported (the card's
    host has no ``tensorboard``); the writer says so once on stderr."""

    def __init__(self, logdir: str | None):
        self._jsonl = None
        if logdir and is_rank0():
            print("metrics: TensorBoard sink not ported to "
                  "distributeddeeplearning_tpu_torch (ROADMAP queue A14); "
                  "writing "
                  f"{os.path.join(logdir, 'metrics.jsonl')} only",
                  file=sys.stderr, flush=True)
            try:
                os.makedirs(logdir, exist_ok=True)
                self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
            except OSError:
                self._jsonl = None

    def write(self, step: int, scalars: dict) -> None:
        if self._jsonl is None:
            return
        try:
            self._jsonl.write(json.dumps({"schema": 1, "step": int(step),
                                         **scalars}) + "\n")
        except (OSError, TypeError, ValueError):
            pass

    def flush(self) -> None:
        if self._jsonl is not None:
            try:
                self._jsonl.flush()
            except OSError:
                pass

    def close(self) -> None:
        if self._jsonl is not None:
            try:
                self._jsonl.flush()
                self._jsonl.close()
            except OSError:
                pass
            self._jsonl = None


def parse_profile_window(spec: str) -> tuple[int, int] | None:
    """'12:20' -> (12, 20); '12' -> (12, 17); '' -> None."""
    if not spec:
        return None
    a, _, b = spec.partition(":")
    start, stop = int(a), int(b or int(a) + 5)
    if stop <= start:
        raise ValueError(f"profile window {spec!r}: stop must be > start")
    return start, stop


class Profiler:
    """``torch.profiler`` over a window of steps (``train.profile_steps``),
    on rank 0: the trace starts when ``step(start)`` is seen and stops at
    ``step(stop)`` (or ``close``), and its Chrome trace goes to
    ``<logdir>/trace_<start>_<stop>.json`` (the temporary directory's
    ``ddl_profile`` without a ``logdir``). CUDA activity is traced where a
    card is present."""

    def __init__(self, window: str, logdir: str):
        self._window = parse_profile_window(window)
        self._logdir = logdir or os.path.join(tempfile.gettempdir(),
                                              "ddl_profile")
        self._prof = None

    def step(self, i: int) -> None:
        if self._window is None or not is_rank0():
            return
        start, stop = self._window
        if i == start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
        elif i >= stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self._logdir, exist_ok=True)
        start, stop = self._window
        prof.export_chrome_trace(os.path.join(self._logdir,
                                              f"trace_{start}_{stop}.json"))
