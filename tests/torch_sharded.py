"""Shared by the tests of the port's tensor and fully sharded parallelism
(``tests/test_torch_tp*.py``, ``tests/test_torch_fsdp.py``): gloo ranks
spawned on the CPU, and the JAX package's Trainer on the same tiny models,
weights and batches; and virtual ranks as threads of one process
(:func:`lockstep`), whose collectives meet at a barrier.

The setting is JAX's ``tests/test_tp_fsdp.py``: the tiny GPT-2 (4 heads,
width 64, vocab 256) or the tiny Llama (4 query heads over 2 KV heads) on
``SyntheticTokens`` batches of 16 x 32 (4 distinct), AdamW at lr 1e-3 —
here with weight decay 0.1 and the global norm clipped at 0.05, which every
step's norm exceeds, so the sharded norm is load-bearing. The port's ranks
start from the same init (the port's one-rank draw, handed to JAX as its
tree), cut to each rank's blocks (``weights.rank_shards``).
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch

RTOL, ATOL = 2e-4, 2e-5
STEPS = 5
MODEL = dict(size="tiny", vocab_size=256, max_len=64)
DATA = dict(batch_size=16, seq_len=32, vocab_size=256, seed=0, n_distinct=4)
OPT = dict(weight_decay=0.1, grad_clip=0.05)
LR = 1e-3


# The spawned ranks' rendezvous ports are taken below the kernel's
# ephemeral range (32768 and up on Linux): a port the kernel hands out as
# a client socket's (every gloo connection of the tests running beside
# this one takes some) can be taken between a test's choice and its bind.
# Each pytest-xdist worker draws from its own slice of the range, so the
# files running side by side never draw the same port.
_PORTS = (20000, 32768)
_SLICES = 8


def _port_range() -> tuple:
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    if not worker.startswith("gw"):
        return _PORTS
    width = (_PORTS[1] - _PORTS[0]) // _SLICES
    lo = _PORTS[0] + (int(worker[2:]) % _SLICES) * width
    return lo, lo + width


def free_port() -> int:
    return free_ports(1)[0]


class LockstepComm:
    """A mesh transport for ranks that are threads of one process: every
    collective is an exchange through shared slots between two barriers."""

    def __init__(self, hub, rank):
        self.hub, self.rank = hub, rank

    def _exchange(self, value):
        hub = self.hub
        hub["slots"][self.rank] = value
        hub["barrier"].wait()
        got = list(hub["slots"])
        hub["barrier"].wait()
        return got

    def shift(self, tensors, axis, ranks, index, shift):
        got = self._exchange([t.clone() for t in tensors])
        return [t.clone() for t in got[ranks[(index - shift) % len(ranks)]]]

    def all_reduce_sum(self, t, axis, op="sum"):
        return sum(self._exchange(t.clone()))

    def all_gather(self, t, axis, out):
        return out.copy_(torch.cat(self._exchange(t.clone())))

    def all_to_all(self, t, axis, ranks, index):
        got = self._exchange(t.clone())
        return torch.stack([got[r][index] for r in ranks])

    def gather_objects(self, obj):
        return self._exchange(obj)


def lockstep(n, fn, **shape):
    """Run ``fn(mesh)`` on ``n`` virtual ranks of a mesh of ``shape``, one
    thread each; returns the results in rank order."""
    import threading

    from distributeddeeplearning_tpu_torch.mesh import Mesh

    hub = {"slots": [None] * n, "barrier": threading.Barrier(n, timeout=120)}
    out, errors = [None] * n, []

    def run(r):
        try:
            out[r] = fn(Mesh(shape, r, LockstepComm(hub, r)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            hub["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def free_ports(n: int) -> list:
    """``n`` distinct free ports (each ``cli`` call of a spawned rank
    joins a group of its own), drawn at random below the ephemeral
    range."""
    import random

    rng, ports = random.Random(), []
    while len(ports) < n:
        port = rng.randrange(*_port_range())
        if port in ports:
            continue
        with socket.socket() as so:
            try:
                so.bind(("localhost", port))
            except OSError:
                continue
        ports.append(port)
    return ports


def join_world(rank: int, world: int, port: int) -> None:
    """A spawned rank joins the gloo job (its prints silenced)."""
    import contextlib
    import io

    from distributeddeeplearning_tpu_torch.mesh import init_distributed

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    with contextlib.redirect_stdout(io.StringIO()):
        assert init_distributed("cpu")


def spawn(worker, nranks: int, tmp, *args, parent=None):
    """``worker(rank, nranks, port, tmp, *args)`` on ``nranks`` gloo ranks,
    while ``parent()`` runs here (JAX's references); then each rank's
    ``rank{r}.pt`` and what ``parent`` returned."""
    ctx = torch.multiprocessing.spawn(
        worker, args=(nranks, free_port(), str(tmp), *args), nprocs=nranks,
        join=False)
    here = parent() if parent is not None else None
    while not ctx.join():
        pass
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(nranks)]
    return ranks, here


def flat_numpy(tree):
    """A JAX params tree (boxed or not) -> a flat state_dict of tensors."""
    import flax.linen as nn
    import jax

    from distributeddeeplearning_tpu_torch.weights import from_jax_params

    return from_jax_params(jax.tree.map(np.asarray, nn.meta.unbox(tree)))


def jax_tree(flat: dict) -> dict:
    """A flat state_dict -> the nested tree of arrays JAX takes."""
    import jax.numpy as jnp

    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.numpy())
    return tree


def port_init(name: str, **model_kw) -> dict:
    """The tiny ``name``'s weights the port draws from seed 0 (one rank),
    as a flat state_dict: the init both packages start from."""
    from distributeddeeplearning_tpu_torch import models

    m = models.get_model(name, **MODEL, **model_kw)
    m.init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def jax_run(name: str, init: dict, steps: int = STEPS, *,
            precision: str = "fp32", grad_accum: int = 1,
            health: bool = False, evals: int = 0, optim: str = "adamw",
            opt: dict | None = None, **model_kw) -> dict:
    """JAX's Trainer on one device: ``steps`` steps of the tiny ``name``
    (gpt2 or llama) from ``init`` (a flat state_dict), with ``optim``
    (``adamw``, or ``sgd`` with momentum 0.9) and ``opt`` (its weight decay
    and clip; default :data:`OPT`). Returns the final params as
    a flat state_dict, the losses, the metrics of each step (``grad_norm``
    under the guard), the optimizer state (host arrays) and, with
    ``evals`` > 0, ``evaluate`` over that many eval batches of the final
    state."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from distributeddeeplearning_tpu import config as jconfig
    from distributeddeeplearning_tpu import data as jdata
    from distributeddeeplearning_tpu import models as jmodels
    from distributeddeeplearning_tpu.mesh import single_device_mesh
    from distributeddeeplearning_tpu.train import (
        Trainer,
        evaluate,
        get_task,
        make_optimizer,
    )

    kw = dict(MODEL, **model_kw)
    if precision != "fp32":
        kw["dtype"] = jnp.bfloat16
    model = jmodels.get_model(name, **kw)
    ds = jdata.SyntheticTokens(**DATA)
    mesh = single_device_mesh()
    tx = make_optimizer(optim, LR, precision=precision,
                        **(OPT if opt is None else opt))
    trainer = Trainer(model, tx, get_task("lm"), mesh, donate=False,
                      precision=precision, grad_accum=grad_accum,
                      health=jconfig.HealthConfig(enabled=True)
                      if health else None)
    state = trainer.init(0, ds.batch(0))
    state = dataclasses.replace(state, params=jax_tree(init))
    losses, metrics = [], []
    for i, batch in enumerate(jdata.sharded_batches(ds, mesh)):
        if i >= steps:
            break
        state, m = trainer.train_step(state, batch)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"losses": losses, "metrics": metrics,
           "params": flat_numpy(state.params),
           "opt_state": jax.tree.map(np.asarray, state.opt_state)}
    if evals:
        eds = jdata.SyntheticTokens(**{**DATA, "seed": 1})
        out["eval"] = evaluate(trainer, state, (
            b for _, b in zip(range(evals),
                              jdata.sharded_batches(eds, mesh))))
    return out


def port_trainer(name: str, mesh, *, sequence_parallel: bool = False,
                 precision: str = "fp32", attn_impl: str = "xla",
                 zero1: bool = False, grad_accum: int = 1,
                 health: bool = False, remat: str = "none", device="cpu",
                 model_kw: dict | None = None, optim: str = "adamw",
                 tx=None):
    """(model, trainer) of the tiny ``name`` on ``mesh``, as ``jax_run``
    sets it up; ``model_kw``: more of the model's arguments; ``tx``: an
    optimizer in place of ``optim``'s."""
    from distributeddeeplearning_tpu_torch import config, models, train

    kw = dict(MODEL, attn_impl=attn_impl, mesh=mesh, **(model_kw or {}))
    if remat != "none":
        kw["remat"] = remat
    if sequence_parallel:
        kw["sequence_parallel"] = True
    if precision != "fp32":
        kw["dtype"] = "bfloat16"
    model = models.get_model(name, **kw).to(device)
    if tx is None:
        tx = train.make_optimizer(optim, LR, precision=precision, **OPT)
    trainer = train.Trainer(
        model, tx, train.get_task("lm", mesh=mesh), device=device,
        precision=precision, mesh=mesh, zero1=zero1, grad_accum=grad_accum,
        health=config.HealthConfig(enabled=True) if health else None)
    return model, trainer


def load_whole(state, whole: dict) -> None:
    """``state``'s params (a rank's blocks, maybe views into ZeRO-1's
    buffers) set to this rank's blocks of the whole ``whole``."""
    from distributeddeeplearning_tpu_torch.weights import rank_shards

    local = rank_shards(whole, state.shards)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(local[k])


def port_run(name: str, mesh, init: dict, steps: int = STEPS, *,
             setup=None, **kw) -> dict:
    """``steps`` Trainer steps of the tiny ``name`` on ``mesh`` from the
    whole ``init``: the losses, each step's metrics, the whole params on
    rank 0 (None elsewhere), and what says the sharding is real.
    ``setup(model)`` runs on the model before the first step."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.parallel import fsdp

    model, trainer = port_trainer(name, mesh, **kw)
    if setup is not None:
        setup(model)
    state = trainer.init(0)
    load_whole(state, init)
    ds = data.SyntheticTokens(**DATA)
    batches = data.sharded_batches(ds.iter_from(0), mesh,
                                   kw.get("grad_accum", 1))
    losses, metrics = [], []
    for _, batch in zip(range(steps), batches):
        state, m = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
    whole = (state.params if state.shards is None
             else state.shards.gather(state.params))
    return {"losses": losses, "metrics": metrics,
            "params": None if whole is None else {
                k: v.detach().clone() for k, v in whole.items()},
            "fraction": {a: fsdp.sharded_fraction(model, a)
                         for a in ("tp", "fsdp", "ep")},
            "bytes": fsdp.per_device_bytes(model),
            "coords": {} if mesh is None else dict(mesh.coords),
            "state": state, "trainer": trainer}


def whole_over_pp(tree: dict, shards) -> dict:
    """A pipeline rank's ``tree`` with each leaf its ``shards`` cut over pp
    (the ``vocab_pp`` tables: a pp rank holds a block of them, at pp alone
    too) all-gathered back over pp (a collective of the rank's pp group);
    the other leaves as they are."""
    if shards is None:
        return dict(tree)
    return {k: shards.gather_axis(k, v.detach(), "pp")
            if "pp" in shards.dims.get(k, {}) else v
            for k, v in tree.items()}


def pp_blocks(shards) -> dict:
    """Each leaf ``shards`` cuts over pp -> the block shape a rank holds."""
    if shards is None:
        return {}
    return {k: shards.local[k] for k, d in shards.dims.items() if "pp" in d}


def assert_params_close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)
