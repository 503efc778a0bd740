"""Training health guard: anomaly detection around the update of every step
(``HealthConfig``), the reference's ``health.py``.

- **non-finite detection**: the step's loss and global gradient norm (the
  Trainer surfaces ``grad_norm`` while a guard is on) must be finite;
- **EMA loss-spike detection**: after ``ema_warmup_steps`` healthy steps,
  ``loss > spike_factor * ema`` also counts as an anomaly;
- **skip-update**: an anomalous step leaves the model bit-identical to not
  having run it (params, moments, the optimizer's count, BatchNorm's
  running statistics); the step counter still advances, so the data stream
  and the per-step dropout seed move on;
- **counters** in ``TrainState.health`` (:class:`HealthState`), surfaced as
  the metrics ``anomalies``, ``consecutive_anomalies`` and ``skipped``, on
  which ``train.fit``'s rollback policy acts.

The reference compiles the guard into the step and selects the old state
with ``jnp.where``. The port's optimizers update params and moments in
place (the fused AdamW kernel writes them), and the optimizer's count is a
host integer, so the guard decides BEFORE the update: the step is staged
(gradients and metrics first, the update as a callable), the loss and the
gradient norm come to the host in one read, and a skipped step never
launches its update. BatchNorm's statistics, which the training forward
updates in place, are restored from a copy taken before it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import HealthConfig

__all__ = ["HealthConfig", "HealthState", "guard_step", "init_health_state"]

_F = np.float32


@dataclasses.dataclass(frozen=True)
class HealthState:
    """The guard's counters, carried in ``TrainState.health`` and
    checkpointed with it: host values, fp32 for the EMA."""

    anomaly_count: int = 0  # total anomalous steps so far
    consecutive: int = 0  # current run of anomalous steps
    loss_ema: np.float32 = _F(0)  # EMA of the loss over healthy steps
    ema_steps: int = 0  # healthy steps absorbed by the EMA

    def as_dict(self) -> dict:
        return {"anomaly_count": self.anomaly_count,
                "consecutive": self.consecutive,
                "loss_ema": float(self.loss_ema),
                "ema_steps": self.ema_steps}

    @classmethod
    def from_dict(cls, d: dict) -> HealthState:
        return cls(int(d["anomaly_count"]), int(d["consecutive"]),
                   _F(d["loss_ema"]), int(d["ema_steps"]))


def init_health_state() -> HealthState:
    return HealthState()


def check(h0: HealthState, loss, grad_norm, cfg: HealthConfig):
    """The guard's decision on host values: ``(ok, h1)``. The EMA moves on
    healthy steps only (a NaN would poison it forever); the first healthy
    loss seeds it. fp32 arithmetic, in the reference's order."""
    loss = _F(loss)
    finite = bool(np.isfinite(loss))
    if grad_norm is not None:
        finite = finite and bool(np.isfinite(_F(grad_norm)))
    ok = finite
    if cfg.spike_factor > 0:
        armed = h0.ema_steps >= cfg.ema_warmup_steps
        spike = armed and finite and bool(
            loss > _F(cfg.spike_factor) * h0.loss_ema)
        ok = ok and not spike
    if not ok:
        return False, dataclasses.replace(
            h0, anomaly_count=h0.anomaly_count + 1,
            consecutive=h0.consecutive + 1)
    ema = (loss if h0.ema_steps == 0
           else _F(cfg.ema_beta) * h0.loss_ema
           + _F(1.0 - cfg.ema_beta) * loss)
    return True, dataclasses.replace(h0, consecutive=0, loss_ema=_F(ema),
                                     ema_steps=h0.ema_steps + 1)


def guard_step(step_fn, cfg: HealthConfig):
    """Wrap a STAGED step body with anomaly detection and skip-update.

    ``step_fn``: ``(state, batch) -> (metrics, commit)``: ``metrics`` holds
    ``loss`` and (when available) ``grad_norm``; ``commit()`` applies the
    update and returns the new state (the step advanced). The wrapped body
    ``(state, batch) -> (new_state, metrics)`` reads the loss and the norm
    on the host once, runs ``commit`` only on a healthy step, and otherwise
    restores ``state.model_state`` and advances the step alone. It adds
    ``anomalies`` (cumulative), ``consecutive_anomalies`` and ``skipped``
    (0/1 for this step) to the metrics."""

    def guarded(state, batch):
        saved = {k: v.clone() for k, v in state.model_state.items()}
        metrics, commit = step_fn(state, batch)
        names = ["loss"] + (["grad_norm"] if "grad_norm" in metrics else [])
        host = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                            .reshape(()) for k in names]).cpu().numpy()
        ok, h1 = check(state.health, host[0],
                       host[1] if len(names) > 1 else None, cfg)
        if ok:
            new_state = commit()
        else:
            with torch.no_grad():
                for k, v in state.model_state.items():
                    v.copy_(saved[k])
            new_state = dataclasses.replace(state, step=state.step + 1)
        new_state = dataclasses.replace(new_state, health=h1)
        return new_state, {
            **metrics, "anomalies": torch.tensor(h1.anomaly_count),
            "consecutive_anomalies": torch.tensor(h1.consecutive),
            "skipped": torch.tensor(int(not ok))}

    return guarded
