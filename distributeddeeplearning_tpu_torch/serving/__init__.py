"""Serving: continuous batching over a paged KV cache, with the prefix
cache, the host spill tier, n-gram speculation, prefill/decode roles and
int8 weights (``quant.py``); N engine replicas behind a router
(``router.py``), in-process or as worker processes over sockets
(``net.py``, ``worker.py``) under a self-healing supervisor
(``fleet_supervisor.py``). Host-side state (scheduler, block pool) and
device-side work (engine) are split so admission policy is testable without
a device."""

from .engine import (  # noqa: F401
    ROUTER_POLICIES,
    SERVABLE_MODELS,
    SERVE_FAULT_KINDS,
    SHED_POLICIES,
    ServingEngine,
    check_serving_composition,
    parse_fault_injection,
    speculation_k,
)
from .fleet_supervisor import (  # noqa: F401
    FleetSupervisor,
    WorkerDied,
)
from .net import (  # noqa: F401
    MAX_FRAME_BYTES,
    FrameDecoder,
    ProtocolError,
    encode_frame,
)
from .router import (  # noqa: F401
    Replica,
    ReplicaRouter,
    RequestShed,
    SocketReplica,
    StaleHeartbeat,
    connect_fleet,
    dial_worker,
)
from .quant import (  # noqa: F401
    dequantize_params,
    quantize_params,
)
from .scheduler import (  # noqa: F401
    KVBlockPool,
    Request,
    RequestState,
    Scheduler,
    blocks_for,
    chain_digests,
    ngram_draft,
)

_WORKER_EXPORTS = ("ReplicaWorker", "check_fleet_composition")


def __getattr__(name):
    # Lazy so `python -m ...serving.worker` (the fleet child entrypoint)
    # does not execute worker.py twice: once through this package import,
    # once as __main__.
    if name in _WORKER_EXPORTS:
        from . import worker

        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
