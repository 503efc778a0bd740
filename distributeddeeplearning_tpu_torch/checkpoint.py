"""Checkpoint / resume of the port: one directory per step, of files that
``torch.save`` writes, written whole or not at all, off the step loop.

The JAX package's ``checkpoint.py`` keeps the same interface over orbax
(async, restoring into any mesh's placement). Here:

- **On disk**, ``<dir>/<step>/state.pt`` holds the step, the root dropout
  seed, the optimizer count, the params, the model's buffers
  (``model_state``: BatchNorm's running statistics) and the optimizer's
  trees (both Adam moments, or SGD's trace) as full params-shaped trees of
  CPU tensors; ``<dir>/<step>/data.json`` the input pipeline's position
  (``{"next_index": N}``), so resume is step-exact.
- **Atomic**: a step is written into ``<dir>/.tmp-<step>`` and renamed to
  ``<dir>/<step>`` once both files are on disk, so :meth:`latest_step`
  never names a half-written step.
- **Asynchronous**: :meth:`save` copies the state to host memory on the
  caller's thread and a background thread writes it; :meth:`wait` drains
  the writes and raises what failed.
- **Any mesh**: under ZeRO-1 every rank calls :meth:`save`, the moments are
  gathered to full leaf shape on rank 0 alone and rank 0 writes;
  :meth:`restore` cuts them to the target state's own layout, so a
  checkpoint saved at dp=2 restores at dp=1 and the other way round.
- **Fallback**: :meth:`restore` with no step walks the steps newest first;
  a step whose files fail to load is quarantined (renamed
  ``<step>.corrupt``) and the next earlier one is tried.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import pickle
import shutil
import sys
import time
import zipfile

import torch

from .mesh import is_rank0

# What a damaged step's files raise from torch.load / json.load.
_LOAD_ERRORS = (OSError, EOFError, RuntimeError, ValueError, KeyError,
                pickle.UnpicklingError, zipfile.BadZipFile)
_KEYS = ("step", "rng", "count", "params")


def _full_opt_trees(opt_state) -> dict | None:
    """The optimizer state's params-shaped trees (``train.opt_state_trees``:
    Adam's mu and nu, or SGD's trace): a ZeRO-1 state's shards gathered on
    rank 0 (a collective of rank 0's dp group; None on every other rank),
    a replicated state's trees as they are."""
    from .parallel.zero import ZeroState
    from .train import opt_state_trees

    if isinstance(opt_state, ZeroState):
        layout = opt_state.layout
        mu, nu = layout.gather(opt_state.mu), layout.gather(opt_state.nu)
        return None if mu is None else {"mu": mu, "nu": nu}
    return opt_state_trees(opt_state)


def _host(state, opt_trees: dict) -> dict:
    """A copy of ``state`` (with the optimizer's full trees ``opt_trees``)
    in host memory, in the layout of ``state.pt``."""
    def host(tree):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    return {"step": int(state.step), "rng": int(state.rng),
            "count": int(state.opt_state.count), "params": host(state.params),
            "model_state": host(state.model_state),
            **{name: host(tree) for name, tree in opt_trees.items()}}


def _check_tree(tree: dict, name: str, like: dict) -> None:
    """Refuse a checkpoint's ``tree`` whose names or shapes are not
    ``like``'s."""
    if set(tree) != set(like):
        raise ValueError(f"checkpoint {name} do not match the model: "
                         f"{sorted(set(tree) ^ set(like))[:8]}")
    for k, p in like.items():
        if tuple(tree[k].shape) != tuple(p.shape):
            raise ValueError(f"checkpoint {name} {k}: shape "
                             f"{tuple(tree[k].shape)}, the model's "
                             f"{tuple(p.shape)}")


@torch.no_grad()
def load_into(state, host: dict):
    """``state`` (the live state of a trainer, or a serving model's params
    with ``opt_state=None``) with the values of ``host`` (a checkpoint's
    ``state.pt``): params, the model's buffers (BatchNorm statistics) and
    the optimizer's trees copied in place, Adam's moments cut to the
    state's ZeRO-1 shards where it has them. A checkpoint of another model
    or optimizer is refused by name."""
    from .parallel.zero import ZeroState
    from .train import opt_state_trees

    opt = state.opt_state
    trees = {} if opt is None else opt_state_trees(opt)
    host_state = host.get("model_state", {})
    for name in ("params", *trees):
        if name not in host:
            raise ValueError(f"checkpoint has no {name}: another "
                             "optimizer's state")
        _check_tree(host[name], name, state.params)
    _check_tree(host_state, "model_state", state.model_state)
    for k, p in state.params.items():
        p.copy_(host["params"][k])
    for k, b in state.model_state.items():
        b.copy_(host_state[k])
    if opt is not None:
        for name, tree in trees.items():
            full = host[name]
            if isinstance(opt, ZeroState):
                full = opt.layout.shard(full)
            for k, t in tree.items():
                t.copy_(full[k])
        opt = opt._replace(count=int(host["count"]))
    return dataclasses.replace(state, step=int(host["step"]),
                               rng=int(host["rng"]), opt_state=opt)


class CheckpointManager:
    """(TrainState, data_state) pairs by step in ``directory``, the JAX
    package's ``CheckpointManager`` interface. ``data_state`` is a small
    JSON-able dict (``{"next_index": N}``). The newest ``max_to_keep``
    steps are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._writer = is_rank0()
        if self._writer:
            os.makedirs(self._directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []
        # The newest step this manager saved or restored. It comes from the
        # state every rank shares, never from a rank's own listing of the
        # directory, so every rank takes the same skip decision in save (a
        # collective under ZeRO-1), and a step quarantined by a restore is
        # saved afresh.
        self._latest_saved: int | None = None
        # One record per save on the writer: seconds on the caller's thread
        # (gather and host copy), seconds writing, bytes on disk.
        self.timings: list[dict] = []

    @property
    def directory(self) -> str:
        return self._directory

    def save(self, step: int, state, data_state: dict | None = None,
             force: bool = False) -> bool:
        """Save ``state`` at ``step`` (returns True), or skip a step no
        newer than the newest one this manager saved or restored (False)
        unless ``force``. Every rank calls it; rank 0 writes."""
        if (not force and self._latest_saved is not None
                and step <= self._latest_saved):
            return False
        self._latest_saved = step
        t0 = time.perf_counter()
        opt_trees = _full_opt_trees(state.opt_state)
        if not self._writer:
            return True
        host = _host(state, opt_trees)
        del opt_trees
        record = {"step": step, "host_s": time.perf_counter() - t0}
        self.timings.append(record)
        self._pending.append(self._pool.submit(
            self._write, step, host, dict(data_state or {}), record))
        return True

    def _write(self, step: int, host: dict, data_state: dict,
               record: dict) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self._directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "state.pt"), "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "data.json"), "w") as f:
            json.dump(data_state, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self._directory, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._directory, str(old)),
                          ignore_errors=True)
        record["write_s"] = time.perf_counter() - t0
        record["bytes"] = sum(os.path.getsize(os.path.join(final, n))
                              for n in os.listdir(final))

    def _load(self, step: int) -> tuple[dict, dict]:
        d = os.path.join(self._directory, str(step))
        host = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                          weights_only=True)
        with open(os.path.join(d, "data.json")) as f:
            data_state = json.load(f)
        missing = [k for k in _KEYS if k not in host]
        if missing:
            raise KeyError(f"state.pt lacks {missing}")
        return host, dict(data_state)

    def _quarantine(self, step: int, reason: str) -> None:
        """Rename a corrupt step's directory to ``<step>.corrupt`` (rank 0),
        so no later listing names it."""
        if not self._writer:
            return
        d = os.path.join(self._directory, str(step))
        try:
            os.rename(d, d + ".corrupt")
        except OSError:
            return
        print(f"WARNING: quarantined corrupt checkpoint step {step} "
              f"({reason}) -> {step}.corrupt", file=sys.stderr, flush=True)

    def restore(self, state, step: int | None = None):
        """``(state, data_state)`` at ``step`` (default: the newest step
        that loads), written into ``state`` (the live state to fill, as the
        reference's abstract state says where each array goes).

        An explicit ``step`` restores exactly that step or raises. With no
        step, a step whose files fail to load (truncated, half-written) is
        quarantined with a warning and the next earlier step is tried; only
        when none loads does the call fail. The restored step is the newest
        one :meth:`save` skips from then on."""
        if step is not None:
            host, data_state = self._load(step)
            return self._restored(state, host), data_state
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self._directory}")
        last_err = None
        for s in steps:
            try:
                host, data_state = self._load(s)
            except _LOAD_ERRORS as e:
                last_err = e
                print(f"WARNING: checkpoint step {s} in {self._directory} "
                      f"failed to load ({type(e).__name__}: {e}) — falling "
                      "back to an earlier step", file=sys.stderr, flush=True)
                self._quarantine(s, type(e).__name__)
                continue
            if s != steps[0]:
                print(f"WARNING: restored fallback checkpoint step {s} "
                      f"(latest was {steps[0]})", file=sys.stderr, flush=True)
            return self._restored(state, host), data_state
        raise RuntimeError(
            f"no restorable checkpoint in {self._directory}: all of steps "
            f"{steps} failed to load") from last_err

    def _restored(self, state, host: dict):
        state = load_into(state, host)
        self._latest_saved = state.step
        return state

    def all_steps(self) -> list[int]:
        try:
            names = os.listdir(self._directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self._directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def corrupt_latest_for_test(self, step: int | None = None) -> int | None:
        """Truncate every file of the latest step (or ``step``) to zero
        bytes, so that :meth:`restore` must take its fallback. Returns the
        step, or None when there is none. For tests and fault injection
        only."""
        step = self.latest_step() if step is None else step
        d = None if step is None else os.path.join(self._directory, str(step))
        if d is None or not os.path.isdir(d):
            return None
        for name in os.listdir(d):
            with open(os.path.join(d, name), "wb"):
                pass
        return step

    def wait(self) -> None:
        """Block until every save so far is on disk; raise what failed."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
