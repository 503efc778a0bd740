"""Shared setting of the port's fleet tests (``tests/test_torch_serving_
router.py``, ``test_torch_serving_worker.py``,
``test_torch_fleet_supervisor.py``): one scenario runs against the JAX
package's serving stack and the port's through a :class:`Side`, which
builds each side's engines, routers, workers and transports on the tiny
GPT-2 of ``tests/torch_serving.py`` (JAX's init at seed 7, loaded into the
port). Clocks are the test's: ``t[0]`` moves only when the test moves it,
so both sides read the same times however often they call the clock.

``share_jax_programs`` lets JAX engines built on the same model, config
and shapes reuse one another's compiled programs: every engine still
counts its own compiles (``num_compiles`` is JAX's), only XLA's build is
skipped, which keeps a file that builds dozens of JAX engines within its
time.
"""

import dataclasses
import socket

import jax
import numpy as np

from distributeddeeplearning_tpu import serving as jax_serving
from distributeddeeplearning_tpu.config import ServingConfig as JaxServing
from distributeddeeplearning_tpu.serving import net as jax_net
from distributeddeeplearning_tpu.serving import router as jax_router
from distributeddeeplearning_tpu.serving import worker as jax_worker
from distributeddeeplearning_tpu.serving import (
    fleet_supervisor as jax_fleet_supervisor,
)
from distributeddeeplearning_tpu.telemetry import (
    NULL_TELEMETRY as JAX_NULL_TELEMETRY,
    Telemetry as JaxTelemetry,
)
from distributeddeeplearning_tpu_torch import serving as port_serving
from distributeddeeplearning_tpu_torch.config import ServingConfig
from distributeddeeplearning_tpu_torch.serving import net as port_net
from distributeddeeplearning_tpu_torch.serving import router as port_router
from distributeddeeplearning_tpu_torch.serving import worker as port_worker
from distributeddeeplearning_tpu_torch.serving import (
    fleet_supervisor as port_fleet_supervisor,
)
from distributeddeeplearning_tpu_torch.telemetry import (
    NULL_TELEMETRY,
    Telemetry,
)
from torch_serving import jax_weights, port_model

# The JAX fleet tests' engine setting (block 4, the 'reference' read path).
BASE = dict(slots=3, block_size=4, hbm_budget_mb=8, max_seq_len=48,
            prompt_buckets=(8, 16))


def cell_clock(t0=100.0):
    t = [t0]
    return t, (lambda: t[0])


def share_jax_programs():
    """Patch the JAX engine's ``_compile`` to reuse a program another
    engine built on the same model, config, program name and argument
    shapes (``num_compiles`` and the telemetry registry still count every
    compile). Returns the undo."""
    Engine = jax_serving.ServingEngine
    orig = Engine._compile
    memo = {}

    def _compile(self, fn, *args, name=None, donate_argnums=()):
        shapes = jax.tree.map(
            lambda x: (np.shape(x), str(getattr(x, "dtype", type(x)))), args)
        key = (repr(self.model), repr(self.cfg), fn.__name__, name,
               repr(shapes), donate_argnums)
        if key not in memo:
            memo[key] = orig(self, fn, *args, name=name,
                             donate_argnums=donate_argnums)
            return memo[key]
        self.num_compiles += 1
        if name is not None:
            self._tel.record_exe(name, memo[key], compile_s=0.0)
        return memo[key]

    Engine._compile = _compile
    return lambda: setattr(Engine, "_compile", orig)


@dataclasses.dataclass
class Side:
    """One package's serving stack on the shared weights."""

    name: str
    params: object = None
    jax_model: object = None

    def __post_init__(self):
        jax_side = self.name == "jax"
        self.serving = jax_serving if jax_side else port_serving
        self.net = jax_net if jax_side else port_net
        self.router_mod = jax_router if jax_side else port_router
        self.worker_mod = jax_worker if jax_side else port_worker
        self.fleet_mod = (jax_fleet_supervisor if jax_side
                          else port_fleet_supervisor)
        self.Config = JaxServing if jax_side else ServingConfig
        self.Request = self.serving.Request
        self.null_telemetry = (JAX_NULL_TELEMETRY if jax_side
                               else NULL_TELEMETRY)
        self.Telemetry = JaxTelemetry if jax_side else Telemetry
        self._port_model = None if jax_side else port_model(self.params)

    def cfg(self, **kw):
        return self.Config(**{**BASE, **kw})

    def engine(self, cfg, clock, **kw):
        if self.name == "jax":
            return self.serving.ServingEngine(self.jax_model, self.params,
                                              cfg, clock=clock, **kw)
        model = (port_model(self.params) if cfg.quant == "int8"
                 else self._port_model)
        return self.serving.ServingEngine(model, cfg, clock=clock,
                                          device="cpu", **kw)

    def router(self, cfg, clock, **kw):
        """The in-process router over ``cfg.replicas`` engines."""
        if self.name == "jax":
            return self.serving.ReplicaRouter(self.jax_model, self.params,
                                              cfg, clock=clock, **kw)
        # int8 weights are quantized in place: a model of their own.
        model = (port_model(self.params) if cfg.quant == "int8"
                 else self._port_model)
        return self.serving.ReplicaRouter(model, cfg, clock=clock,
                                          device="cpu", **kw)

    def transports_router(self, cfg, clock, transports, **kw):
        args = (None, None) if self.name == "jax" else (None,)
        return self.serving.ReplicaRouter(*args, cfg, clock=clock,
                                          transports=transports, **kw)

    def replica(self, index, engine):
        return self.router_mod.Replica(index=index, engine=engine,
                                       telemetry=self.null_telemetry)

    def mint_worker(self, index, cfg, clock, *, telemetry=None,
                    spill_store=None, warm=True):
        """One worker over a socketpair and its connected transport, the
        way a spawned worker boots (warmup, the spill store re-warmed when
        present). Returns (worker, transport, chains re-warmed)."""
        import os

        router_side, worker_side = socket.socketpair()
        router_side.setblocking(False)
        worker_side.setblocking(False)
        tel = telemetry if telemetry is not None else self.null_telemetry
        engine = self.engine(cfg, clock, telemetry=tel)
        if warm:
            engine.warmup()
        rewarm = 0
        if (spill_store and os.path.exists(spill_store)
                and engine.spill_blocks):
            rewarm = engine.load_spill_store(spill_store)
        w = self.worker_mod.ReplicaWorker(
            engine, worker_side, replica_index=index, clock=clock,
            sleep=lambda s: None,
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            telemetry=tel, spill_store=spill_store,
            spill_checkpoint_every_s=cfg.spill_checkpoint_every_s,
        )
        w.start()
        dec = self.net.FrameDecoder()
        frames = self.net.recv_available(router_side, dec) or []
        assert frames and frames[0]["type"] == "hello"
        transport = self.serving.SocketReplica(
            index, router_side, frames[0], clock=clock, decoder=dec,
            backlog=frames[1:],
        )
        return w, transport, rewarm

    def socket_fleet(self, n, cfg, clock, *, roles=None, **kw):
        """n workers over socketpairs behind a router of SocketReplica
        transports: (workers, router)."""
        workers, transports = [], []
        for i in range(n):
            c = (dataclasses.replace(cfg, role=roles[i]) if roles
                 else cfg)
            w, tr, _ = self.mint_worker(i, c, clock, **kw)
            workers.append(w)
            transports.append(tr)
        return workers, self.transports_router(cfg, clock, transports)


def sides():
    """The JAX side and the port's on the same weights."""
    jm, params = jax_weights()
    return Side("jax", params, jm), Side("port", params, jm)


def drive(router, workers, t, *, dt=0.01, pump=None, max_iters=5000):
    """Tick a socket fleet to idle: advance the clock, pump every live
    worker (or the ``pump`` subset), step the router. Returns the finished
    states."""
    for _ in range(max_iters):
        if router.idle:
            return router.finished()
        t[0] += dt
        for w in (pump if pump is not None else workers):
            if w.exit_code is None:
                w.pump()
        router.step()
    raise AssertionError("fleet never drained idle")


def tokens(states):
    return {int(s.request.request_id): list(s.generated) for s in states}


def submit_all(router, side, prompts, max_new, start=0, **kw):
    for i, p in enumerate(prompts, start=start):
        router.submit(side.Request(prompt=list(p), max_new_tokens=max_new,
                                   request_id=i, **kw))
