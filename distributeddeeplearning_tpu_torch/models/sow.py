"""Values a training forward hands to the Trainer beside its output: flax's
``sow`` into the ``losses`` and ``metrics`` collections.

The Trainer opens :func:`collecting` around a training forward; a module
calls :func:`sow_loss` (an objective term, such as the MoE router's
load-balancing loss) or :func:`sow_metric` (an observable, such as the
router's dropped fraction). Outside a collection, as in an evaluation or a
serving forward, nothing is kept, as JAX's ``mutable=[]`` keeps nothing.
The recompute of a checkpointed block (``remat.recomputing()``) sows
nothing either, so a value is counted once under ``train.remat``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from .remat import recomputing

_LOCAL = threading.local()


@dataclasses.dataclass
class Sown:
    """One forward's sown values, each list in the order of the calls:
    ``losses`` (name, value) pairs and ``metrics`` by name."""

    losses: list = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def collecting():
    """Collect what the forward run inside sows (this thread's)."""
    prev = getattr(_LOCAL, "sown", None)
    _LOCAL.sown = Sown()
    try:
        yield _LOCAL.sown
    finally:
        _LOCAL.sown = prev


def _target() -> Sown | None:
    sown = getattr(_LOCAL, "sown", None)
    return None if sown is None or recomputing() else sown


def sow_loss(name: str, value: torch.Tensor) -> None:
    sown = _target()
    if sown is not None:
        sown.losses.append((name, value))


def sow_metric(name: str, value: torch.Tensor) -> None:
    sown = _target()
    if sown is not None:
        sown.metrics.setdefault(name, []).append(value)
