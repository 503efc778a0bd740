"""Metric-stream records: the training loop's interval records and the
serving engine's lifecycle events and gauges, the same record shapes as the
JAX package's ``metrics`` module so one stream consumer reads both."""

from __future__ import annotations

import torch


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

    def _materialize(self, item) -> None:
        step, host, event, extras = item
        if event is not None:
            event.synchronize()
        self._emit(train_record(step, host, **extras))
