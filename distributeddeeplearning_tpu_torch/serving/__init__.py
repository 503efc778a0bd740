"""Serving: continuous batching over a paged KV cache, with the prefix
cache, the host spill tier, n-gram speculation, prefill/decode roles and
int8 weights (``quant.py``). Host-side state (scheduler, block pool) and
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
from .scheduler import (  # noqa: F401
    KVBlockPool,
    Request,
    RequestState,
    Scheduler,
    blocks_for,
    chain_digests,
    ngram_draft,
)
