"""Checkpoint / resume of the port: one directory per step, of files that
``torch.save`` writes, written whole or not at all, off the step loop.

The JAX package's ``checkpoint.py`` keeps the same interface over orbax
(async, restoring into any mesh's placement). Here:

- **On disk**, ``<dir>/<step>/state.pt`` holds the step, the root dropout
  seed, the optimizer count, the params, the model's buffers
  (``model_state``: BatchNorm's running statistics), the optimizer's
  trees (both Adam moments in their own dtype, bf16 under ``bf16_full``, or
  SGD's trace) as full params-shaped trees of CPU tensors, and the health
  guard's counters when the guard is on; ``<dir>/<step>/data.json`` the input pipeline's position
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
  checkpoint saved at dp=2 restores at dp=1 and the other way round. A
  pipelined model's stage leaves are written whole, ``[num_stages, ...]``
  as the reference's stacked layout: the save gathers every stage's rows
  of the params and the optimizer's trees over ``pp`` (after ZeRO-1's
  gather over dp), and a restore gives each rank its rows, so a ``pp=4``
  checkpoint resumes at ``pp=1`` and the other way round. A model cut over
  tp or fsdp is written in the one-rank layout (the JAX package's keys and
  shapes): the save puts the blocks of the params and the optimizer's trees
  together on rank 0 (``sharding.ShardLayout.gather``, after ZeRO-1's
  gather, and before the pp gather of a pipelined model's stage rows), and
  a restore cuts them for any mesh.
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


def _full_opt_trees(opt_state, dp_sync=None) -> dict | None:
    """The optimizer state's params-shaped trees (``train.opt_state_trees``:
    Adam's mu and nu, or SGD's trace): a ZeRO-1 state's shards, or the
    sharded update's flat shards (``dp_sync``), gathered on member 0 of
    each dp group (a collective of the group; None on every other rank), a
    replicated state's trees as they are."""
    from .train import opt_state_trees

    trees = opt_state_trees(opt_state)
    gather = (dp_sync.gather if dp_sync is not None and dp_sync.sharded
              else opt_state.layout.gather if hasattr(opt_state, "layout")
              else None)
    if gather is None:
        return trees
    full = {name: gather(tree) for name, tree in trees.items()}
    return None if any(t is None for t in full.values()) else full


def _residual_rows(state) -> dict | None:
    """The error-feedback residual of every dp rank on rank 0: each leaf's
    (or bucket's) ``[dp, ...]`` rows in member order, the reference's
    stacked layout, with what they are tied to (``DpSync.signature``).
    None elsewhere and where the state has none. A collective of the dp
    group."""
    res, sync = state.grad_residual, state.dp_sync
    if res is None:
        return None
    tree = ({f"bucket_{b}": r for b, r in enumerate(res)}
            if isinstance(res, tuple) else res)
    rows = {k: sync.gather_rows(t) for k, t in tree.items()}
    if any(v is None for v in rows.values()):
        return None
    return {"signature": sync.signature(),
            "rows": {k: v.to("cpu", copy=True) for k, v in rows.items()}}


def _whole_trees(state) -> tuple:
    """(params, the optimizer's trees) of the whole model on rank 0, in
    the checkpoint's layout: a pipelined model's stage leaves gathered over
    pp to all their rows. (None, None) on the other ranks, which take part
    in the gathers."""
    trees = _full_opt_trees(state.opt_state, state.dp_sync)
    params = state.params
    shards = getattr(state, "shards", None)
    if shards is not None:
        if trees is None:
            return None, None  # a ZeRO-1 dp member off 0: member 0 saves
        # After ZeRO-1's gather over dp: every tp, fsdp and ep block of the
        # dp member 0s, put together on their member 0 (each pp stage's
        # on its own).
        params = shards.gather(params)
        trees = {n: shards.gather(t) for n, t in trees.items()}
    rows = state.stage_rows
    if rows is not None and rows.mesh is not None and params is not None:
        # Then every stage's rows over pp, on rank 0.
        params = rows.gather(params)
        if trees is not None:
            trees = {n: rows.gather(t) for n, t in trees.items()}
    if params is None or trees is None or any(
            t is None for t in trees.values()):
        return None, None
    return params, trees


def _host(state, params: dict, opt_trees: dict) -> dict:
    """A copy of ``state`` (with its whole ``params`` and the optimizer's
    full trees ``opt_trees``) in host memory, in the layout of
    ``state.pt``."""
    def host(tree):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    out = {"step": int(state.step), "rng": int(state.rng),
           "count": int(state.opt_state.count), "params": host(params),
           "model_state": host(state.model_state),
           **{name: host(tree) for name, tree in opt_trees.items()}}
    if state.health is not None:
        out["health"] = state.health.as_dict()
    return out


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
    the optimizer's trees copied in place, a pipelined model's stage leaves
    cut to the rows the state holds, Adam's moments cut to the state's
    ZeRO-1 shards where it has them. A checkpoint of another model or
    optimizer is refused by name."""
    from .train import opt_state_trees

    opt = state.opt_state
    trees = {} if opt is None else opt_state_trees(opt)
    sync = getattr(state, "dp_sync", None)
    residual = _restored_residual(state, host.get("grad_residual"))
    rows = getattr(state, "stage_rows", None)
    if rows is not None:
        host = {**host, **{name: rows.take(host[name])
                           for name in ("params", *trees) if name in host}}
    shards = getattr(state, "shards", None)
    if shards is not None:
        host = {**host, **{name: shards.take(host[name])
                           for name in ("params", *trees) if name in host}}
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
            if sync is not None and sync.sharded:
                full = sync.local(full)
            elif hasattr(opt, "layout"):
                full = opt.layout.shard(full)
            for k, t in tree.items():
                t.copy_(full[k])
        opt = opt._replace(count=int(host["count"]))
    health = state.health
    if health is not None and "health" in host:
        from .health import HealthState

        health = HealthState.from_dict(host["health"])
    return dataclasses.replace(state, step=int(host["step"]),
                               rng=int(host["rng"]), opt_state=opt,
                               health=health, grad_residual=residual)


def _restored_residual(state, saved):
    """This rank's error-feedback residual from a checkpoint's stacked
    ``saved`` rows, or the state's own where it has none. A residual is
    each rank's own compression error, so a checkpoint whose dp size,
    buckets or chunks differ from the state's is refused by name, as is
    one without a residual for a state that carries one."""
    res = getattr(state, "grad_residual", None)
    if res is None:
        return res
    if saved is None:
        raise ValueError(
            "checkpoint has no grad_residual: it was saved with "
            "train.grad_comm='fp32', and a compressed sync resumes only "
            "from its own residual")
    sync = state.dp_sync
    want = sync.signature()
    if saved["signature"] != want:
        def brief(sig):
            b = sig["buckets"]
            return (f"dp={sig['dp']}, "
                    f"{'no' if b is None else len(b['buckets'])} buckets, "
                    f"chunks {sig['chunks'] or 'replicated'}")

        raise ValueError(
            f"checkpoint grad_residual was saved at "
            f"{brief(saved['signature'])}, the state's sync is at "
            f"{brief(want)}: the error-feedback residual is each dp rank's "
            "own, so a restore needs the same mesh.dp, train.grad_bucket_mb, "
            "update_sharding and comm_hierarchy")
    rows = saved["rows"]
    if isinstance(res, tuple):
        got = tuple(rows[f"bucket_{b}"][sync.index] for b in range(len(res)))
        pairs = zip(res, got)
    else:
        _check_tree({k: v[sync.index] for k, v in rows.items()},
                    "grad_residual", res)
        pairs = ((t, rows[k][sync.index]) for k, t in res.items())
    with torch.no_grad():
        for t, v in pairs:
            t.copy_(v)
    return res


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
        params, opt_trees = _whole_trees(state)
        residual = _residual_rows(state)
        if not self._writer:
            return True
        host = _host(state, params, opt_trees)
        if residual is not None:
            host["grad_residual"] = residual
        del params, opt_trees, residual
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
