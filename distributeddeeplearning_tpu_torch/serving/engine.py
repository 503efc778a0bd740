"""Continuous-batching serving engine over the paged KV cache.

Generation is two bodies (``generate.prefill`` / ``generate.decode_step``),
as in the JAX package's engine, run eagerly here:

- **prefill** — one B=1 forward over the whole (bucket-padded) prompt:
  writes the prompt's KV into the request's pool pages and samples the
  first token from the real last position (``generate.logits_at``);
- **decode** — one token for the WHOLE in-flight batch per call, B =
  ``serving.slots`` always (idle lanes ride along pointed at the null
  block 0 with cursor 0).

The KV pool tensors are batch-independent (``models.transformer.
PagedKVCache``), so the SAME tensors serve both bodies and are updated in
place. The HOST is the source of truth for page tables and sequence
lengths: they are rebuilt from scheduler state and handed to every call
(``_inject``), range-checked first.

Sampling is per REQUEST: temperature / top_k / top_p are per-lane operands
of ``generate._filter_logits`` (0 = off / greedy), and each lane draws from
its own ``torch.Generator`` seeded from ``(seed, request_id)``, so one
decode batch can mix greedy and sampled requests and a request's tokens do
not depend on its batchmates. (The JAX engine's ``fold_in`` key chain
cannot be reproduced in torch: greedy output matches it exactly, sampled
output matches it in distribution.)

The serving features, each as in the JAX engine:

- **prefix cache** (``serving.prefix_cache``): the pool runs the
  content-addressed prefix trie (``scheduler.KVBlockPool``); matched
  blocks are mapped into the page table and the same prefill body runs
  over the uncached suffix with the cursor at ``cached_len`` (positions,
  the causal mask and the KV scatter all derive from ``seq_lens``).
  ``serving.suffix_buckets`` adds narrow prefill widths. A full-prefix hit
  (all but the last prompt token cached) skips prefill: the lane is armed
  with the last prompt token and the next decode step writes its KV in
  the request's own block;
- **host spill tier** (``serving.spill_blocks``, ``spill_codec``):
  eviction demotes a refcount-0 trie block's KV into a host store keyed by
  chain hash (one device-to-host copy per eviction batch); admission
  matches through spilled nodes, and their payloads are copied back into
  fresh device blocks before the request's prefill. ``'fp'`` keeps the
  pool's bytes (an int8 pool's codes and scales too); ``'int8'`` goes
  through ``comms_quant.block_quantize``;
- **speculation** (``serving.speculation='ngram:K'``): host-drafted
  n-gram continuations verified in one ``generate.verify_step`` of K+1
  positions a lane, on the gather read path (the paged kernel is
  single-token); greedy only, token for token the plain engine's output;
- **roles** (``serving.role``): a ``'prefill'`` engine prefills, publishes
  the prompt's blocks and queues a handoff record (chain digests and the
  blocks' raw bytes, :meth:`ServingEngine.take_handoffs`); a ``'decode'``
  engine grafts them into its own pool (:meth:`ServingEngine.adopt_chain`)
  so the request admits as a near-full prefix hit;
- **int8 weights** (``serving.quant='int8'``, ``serving/quant.py``);
- **static batching** (admission only into an empty engine), the
  benchmarks' baseline;
- **telemetry** (``telemetry.Telemetry``): ``schedule``/``prefill``/
  ``decode`` spans, the ``ttft``, ``queue_wait``, ``cached_prefill_skip``,
  ``promote_stage``/``promote_wait`` and ``spec_accept`` histograms, the
  gauge digest and the programs' registry.

Replicas behind a router (``serving.replicas``, ``serving/router.py``) and
the socket fleet of worker processes (``cli serve --fleet N``,
``serving/worker.py``, ``serving/fleet_supervisor.py``) are built on this
engine: :meth:`ServingEngine.drain` cuts its intake, and
:meth:`ServingEngine.prefix_match_digests` /
:meth:`ServingEngine.prefix_digest_summary` are the router's read-only
probes of its trie.

``num_compiles`` keeps the JAX engine's meaning: the distinct programs the
engine has readied — the decode step, each prefill width (prompt and
suffix buckets), the verify step — whether :meth:`ServingEngine.warmup`
readied them or their first call did. Eager torch compiles nothing, so the
count is of programs, not of builds; it equals the JAX engine's on the
same config and trace, and steady traffic adds none.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..comms_quant import _pad_to, block_dequantize, block_quantize
from ..generate import (
    _filter_logits, decode_step, logits_at, prefill, verify_step,
)
from ..metrics import serving_event, serving_gauges
from ..models.transformer import PagedKVCache, paged_pool_specs
from ..telemetry import NULL_TELEMETRY, SPEC_ACCEPT_HIST
from .quant import quantize_params
from .scheduler import (
    KVBlockPool, Request, RequestState, Scheduler, blocks_for,
    chain_digests, ngram_draft,
)

KV_QUANT_MODES = ("off", "int8")
SERVABLE_MODELS = ("gpt2", "llama")
ROUTER_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")
SHED_POLICIES = ("off", "deadline")
SERVING_ROLES = ("unified", "prefill", "decode")
SERVE_FAULT_KINDS = (
    "worker_crash", "worker_hang", "conn_drop", "heartbeat_stall"
)
# int8 spill codec granularity (elements a scale), as the reference's.
_SPILL_QBLOCK = 256


# ---------------------------------------------------------------------------
# Composition fences: the reference's, unchanged
# ---------------------------------------------------------------------------


def speculation_k(spec: str) -> int:
    """``serving.speculation``: ``'off'`` -> 0, ``'ngram:K'`` -> K (>= 1)."""
    spec = str(spec)
    if spec == "off":
        return 0
    head, _, tail = spec.partition(":")
    if head != "ngram" or not tail:
        raise ValueError(
            f"serving.speculation must be 'off' or 'ngram:K', got {spec!r}"
        )
    try:
        k = int(tail)
    except ValueError:
        raise ValueError(
            f"serving.speculation must be 'off' or 'ngram:K' with integer "
            f"K, got {spec!r}"
        ) from None
    if k < 1:
        raise ValueError(
            f"serving.speculation='ngram:{k}': K must be >= 1 (K=0 is "
            "spelled speculation='off')"
        )
    return k


def _check_speculation(spec: str, block_size: int, attn_kernel: str) -> int:
    k = speculation_k(spec)
    if k == 0:
        return 0
    if k >= block_size:
        raise NotImplementedError(
            f"serving.speculation='ngram:{k}' x block_size={block_size}: "
            "one verify step writes K positions past the row cursor and "
            "the page table is widened by exactly one draft window, so K "
            "must stay below block_size — lower K or raise block_size"
        )
    if attn_kernel == "pallas":
        raise NotImplementedError(
            f"serving.speculation='ngram:{k}' x attn_kernel='pallas': the "
            "paged-attention kernel is single-token (L == 1) and the "
            "batched verify forward needs L = K+1 — speculation runs on "
            "attn_kernel='reference'"
        )
    return k


def _check_prefix_cache(prefix_cache, suffix_buckets,
                        prompt_buckets) -> tuple[int, ...]:
    sb = tuple(int(b) for b in (suffix_buckets or ()))
    if sb and not prefix_cache:
        raise ValueError(
            f"serving.suffix_buckets={sb} x prefix_cache=False: suffix "
            "buckets only shape the suffix-only prefill path — set "
            "serving.prefix_cache=true or drop them (a silently ignored "
            "knob is a config bug)"
        )
    if not sb:
        return sb
    if list(sb) != sorted(set(sb)) or sb[0] < 1:
        raise ValueError(
            "serving.suffix_buckets must be strictly increasing positive "
            f"lengths, got {suffix_buckets!r}"
        )
    buckets = tuple(int(b) for b in prompt_buckets)
    overlap = sorted(set(sb) & set(buckets))
    if overlap:
        raise ValueError(
            f"serving.suffix_buckets {overlap} duplicate prompt_buckets "
            "entries — pick distinct widths or drop the duplicates"
        )
    if sb[-1] >= buckets[-1]:
        raise ValueError(
            f"serving.suffix_buckets entry {sb[-1]} is not below the "
            f"largest prompt bucket {buckets[-1]}: a suffix is always "
            "shorter than its prompt, so that width could never be selected"
        )
    return sb


def _check_spill(spill_blocks, spill_codec, prefix_cache) -> int:
    sb = int(spill_blocks or 0)
    if sb < 0:
        raise ValueError(
            f"serving.spill_blocks must be >= 0 (0 = no host tier), got "
            f"{spill_blocks}"
        )
    codec = str(spill_codec or "fp")
    if codec not in ("fp", "int8"):
        raise ValueError(
            f"serving.spill_codec must be 'fp' or 'int8', got "
            f"{spill_codec!r}"
        )
    if sb and not prefix_cache:
        raise ValueError(
            f"serving.spill_blocks={sb} x prefix_cache=False: the host "
            "tier stores evicted prefix-TRIE blocks, and without the trie "
            "there is nothing to spill — set serving.prefix_cache=true or "
            "spill_blocks=0"
        )
    if codec != "fp" and not sb:
        raise ValueError(
            "serving.spill_codec='int8' x spill_blocks=0: the codec only "
            "shapes the host spill tier, which spill_blocks=0 disables — "
            "set spill_blocks > 0 or drop the codec"
        )
    return sb


def _check_kv_quant(kv_quant, spill_codec) -> str:
    mode = str(kv_quant or "off")
    if mode not in KV_QUANT_MODES:
        raise ValueError(
            f"serving.kv_quant must be one of {KV_QUANT_MODES}, got "
            f"{kv_quant!r}"
        )
    if mode == "int8" and str(spill_codec or "fp") == "int8":
        raise ValueError(
            "serving.kv_quant='int8' x spill_codec='int8': the device "
            "pool is ALREADY int8 — re-quantizing spilled payloads would "
            "compound quantization error for zero bytes saved. Keep "
            "spill_codec='fp' or kv_quant='off'."
        )
    return mode


def _check_role(role, prefix_cache, speculation) -> str:
    r = str(role or "unified")
    if r not in SERVING_ROLES:
        raise ValueError(
            f"serving.role must be one of {SERVING_ROLES}, got {role!r}"
        )
    if r != "unified" and not prefix_cache:
        raise ValueError(
            f"serving.role={r!r} x prefix_cache=False: the prefix trie IS "
            "the handoff ledger, so role-split serving requires "
            "serving.prefix_cache=true"
        )
    if r == "prefill" and str(speculation or "off") != "off":
        raise ValueError(
            f"serving.role='prefill' x speculation={speculation!r}: "
            "drafting and verify are DECODE-side work and a prefill "
            "replica never decodes — set speculation='off' on prefill "
            "replicas"
        )
    return r


def parse_fault_injection(spec) -> "tuple[str, int] | None":
    """``serving.fault_injection`` ('' or '<kind>:K') -> ``(kind, step)``."""
    text = str(spec or "").strip()
    if not text:
        return None
    kind, sep, raw_step = text.partition(":")
    if kind not in SERVE_FAULT_KINDS:
        raise ValueError(
            f"serving.fault_injection kind must be one of "
            f"{SERVE_FAULT_KINDS}, got {spec!r}"
        )
    try:
        step = int(raw_step)
    except ValueError:
        step = -1
    if not sep or step < 0:
        raise ValueError(
            f"serving.fault_injection={spec!r}: expected '<kind>:K' with "
            "integer step K >= 0"
        )
    return kind, step


def _check_fleet_healing(s, fleet: int) -> None:
    if s.max_worker_restarts < 0:
        raise ValueError(
            f"serving.max_worker_restarts must be >= 0 (0 = never "
            f"restart, quarantine forever), got {s.max_worker_restarts}"
        )
    base, cap = s.restart_backoff_base_s, s.restart_backoff_max_s
    if base <= 0 or cap < base:
        raise ValueError(
            "serving restart backoff must satisfy 0 < "
            f"restart_backoff_base_s <= restart_backoff_max_s, got "
            f"base={base} max={cap}"
        )
    cadence = s.spill_checkpoint_every_s
    if cadence < 0:
        raise ValueError(
            "serving.spill_checkpoint_every_s must be >= 0 (0 = "
            f"checkpoint only on clean drain), got {cadence}"
        )
    if cadence > 0 and not s.spill_blocks:
        raise ValueError(
            "serving.spill_checkpoint_every_s x spill_blocks=0: the "
            "periodic checkpoint persists the host spill tier, which "
            "spill_blocks=0 disables — set spill_blocks > 0 or drop the "
            "cadence"
        )
    fault = parse_fault_injection(s.fault_injection)
    if fault is not None and fleet < 1:
        raise NotImplementedError(
            f"serving.fault_injection={s.fault_injection!r} x in-process "
            "serve: fault injection kills/wedges a WORKER PROCESS, which "
            "only exists under `serve --fleet N` — run a fleet or drop "
            "the fault spec"
        )


def check_serving_composition(cfg, *, fleet: int = 0) -> None:
    """Config-time composition fences for ``serve`` (fail BY NAME before any
    build): every fence of the JAX package's engine, unchanged — including
    ``pallas x block_size % 8``, which the CUDA kernel would not need.
    ``fleet`` is ``cli serve --fleet N``'s N (0 = in-process serve).
    ``cfg`` is the full Config."""
    name = cfg.model.name
    if name.endswith("_pp"):
        raise NotImplementedError(
            f"serving x pipelined model ({name!r}): the pipeline engine "
            "owns its own step program and has no decode path — serve the "
            "equivalent dense model"
        )
    if name in ("gpt2_moe", "llama_moe"):
        raise NotImplementedError(
            f"serving x capacity-MoE ({name!r}): batched paged prefill "
            "routes the whole prompt through expert capacity at once and "
            "can drop tokens a one-token stream would keep — MoE serving "
            "needs the one-token prefill path, not built yet"
        )
    if name not in SERVABLE_MODELS:
        raise ValueError(
            f"serving supports decode-capable LMs {SERVABLE_MODELS}, got "
            f"model.name={name!r}"
        )
    attn = cfg.model.kwargs.get("attn_impl", "xla")
    if attn != "xla":
        raise NotImplementedError(
            f"serving x attn_impl={attn!r}: fused/ring attention kernels "
            "are a training feature — the paged decode cache runs the xla "
            "core only (set model.kwargs.attn_impl='xla' or drop it)"
        )
    s = cfg.serving
    if s.quant not in ("none", "int8"):
        raise ValueError(
            f"serving.quant must be 'none' or 'int8', got {s.quant!r}"
        )
    if s.slots < 1:
        raise ValueError(f"serving.slots must be >= 1, got {s.slots}")
    if s.block_size < 1:
        raise ValueError(
            f"serving.block_size must be >= 1, got {s.block_size}"
        )
    buckets = tuple(s.prompt_buckets)
    if not buckets or list(buckets) != sorted(set(buckets)) or buckets[0] < 1:
        raise ValueError(
            "serving.prompt_buckets must be strictly increasing positive "
            f"lengths, got {s.prompt_buckets!r}"
        )
    kernel = s.attn_kernel
    if kernel not in ("reference", "pallas"):
        raise ValueError(
            "serving.attn_kernel must be 'reference' or 'pallas', got "
            f"{kernel!r}"
        )
    if kernel == "pallas" and s.block_size % 8:
        raise NotImplementedError(
            f"serving.attn_kernel='pallas' x block_size={s.block_size}: "
            "the reference kernel streams whole pool blocks through the "
            "(8, 128) sublane tile, so block_size must be a multiple of 8 "
            "— pick a multiple of 8 or keep attn_kernel='reference'"
        )
    if s.max_prefills_per_step < 0:
        raise ValueError(
            "serving.max_prefills_per_step must be >= 0 (0 = uncapped), "
            f"got {s.max_prefills_per_step}"
        )
    if s.replicas < 1:
        raise ValueError(
            f"serving.replicas must be >= 1, got {s.replicas} — 1 serves "
            "through a single engine, > 1 fronts N replicas with a "
            "ReplicaRouter"
        )
    if s.router_policy not in ROUTER_POLICIES:
        raise ValueError(
            f"serving.router_policy must be one of {ROUTER_POLICIES}, got "
            f"{s.router_policy!r}"
        )
    prefix_on = bool(s.prefix_cache)
    _check_prefix_cache(prefix_on, s.suffix_buckets, buckets)
    _check_spill(s.spill_blocks, s.spill_codec, prefix_on)
    _check_kv_quant(s.kv_quant, s.spill_codec)
    if s.router_policy == "prefix_affinity" and not prefix_on:
        raise ValueError(
            "serving.router_policy='prefix_affinity' x prefix_cache=False: "
            "affinity scores replicas by their prefix-trie digest, which "
            "only exists with serving.prefix_cache=true — enable the cache "
            "or use router_policy='least_loaded'"
        )
    if s.shed_policy not in SHED_POLICIES:
        raise ValueError(
            f"serving.shed_policy must be one of {SHED_POLICIES}, got "
            f"{s.shed_policy!r}"
        )
    if not 0.0 < s.shed_percentile <= 100.0:
        raise ValueError(
            f"serving.shed_percentile must be in (0, 100], got "
            f"{s.shed_percentile}"
        )
    _check_speculation(s.speculation, s.block_size, kernel)
    _check_role(s.role, prefix_on, s.speculation)
    pr = int(s.prefill_replicas)
    if pr < 0:
        raise ValueError(
            f"serving.prefill_replicas must be >= 0 (0 = no role split), "
            f"got {pr}"
        )
    if pr > 0:
        if fleet < 1:
            raise ValueError(
                f"serving.prefill_replicas={pr} x in-process serve: the "
                "role split pins WORKER PROCESSES to phases, which only "
                "exist under `serve --fleet N` — run a fleet or drop the "
                "split"
            )
        if pr >= fleet:
            raise ValueError(
                f"serving.prefill_replicas={pr} x fleet={fleet}: a split "
                "fleet needs at least one decode replica "
                "(prefill_replicas < fleet) — no one would ever emit a "
                "token"
            )
        if not prefix_on:
            raise ValueError(
                f"serving.prefill_replicas={pr} x prefix_cache=False: "
                "the prefix trie is the handoff ledger on BOTH sides of "
                "the split — set serving.prefix_cache=true"
            )
    if int(s.handoff_blocks_per_frame) < 1:
        raise ValueError(
            "serving.handoff_blocks_per_frame must be >= 1, got "
            f"{s.handoff_blocks_per_frame}"
        )
    _check_fleet_healing(s, fleet)


def _lane_seed(seed: int, request_id: int) -> int:
    """The per-request sampling seed: ``(seed, request_id)`` packed into
    one 64-bit integer."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(request_id) & 0xFFFFFFFF)


class ServingEngine:
    """Continuous batching over ``cfg.slots`` decode lanes.

    ``submit()`` enqueues requests; every ``step()`` retires finished
    lanes, admits from the queue (one bucketed prefill per admission), and
    runs ONE decode (or verify) call for the whole batch. ``run()`` drains
    to idle.

    ``model`` is a GPT-2 or a Llama of this package with its weights
    loaded; the engine moves it to ``device`` (``None`` = the GPU; the CPU
    only when asked) and, with ``quant='int8'``, quantizes its weights in
    place. ``cfg`` is a ``ServingConfig``. ``clock`` is injectable for
    deterministic tests; ``emit`` receives ``metrics.serving_event``
    records (default: collected on ``self.events``); ``telemetry`` is a
    ``telemetry.Telemetry`` (default: the inert one).
    ``static_batching=True`` admits only into an empty engine.
    """

    def __init__(self, model, cfg, *, emit=None, clock=time.monotonic,
                 seed: int = 0, static_batching: bool = False,
                 telemetry=None, device=None):
        if getattr(model, "attn_impl", "xla") != "xla":
            raise NotImplementedError(
                f"serving x attn_impl={model.attn_impl!r} (see "
                "check_serving_composition)"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.clock = clock
        self.static_batching = bool(static_batching)
        self.events: list[dict] = []
        self._emit = emit if emit is not None else self.events.append
        self._tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.gauge_every = int(cfg.gauge_every)
        self.max_seq_len = int(cfg.max_seq_len) or int(model.max_len)
        if self.max_seq_len > int(model.max_len):
            raise ValueError(
                f"serving.max_seq_len {self.max_seq_len} exceeds the "
                f"model's max_len {model.max_len}"
            )
        self.buckets = tuple(sorted(int(b) for b in cfg.prompt_buckets))
        if self.buckets[-1] >= self.max_seq_len:
            raise ValueError(
                f"largest prompt bucket {self.buckets[-1]} leaves no room "
                f"for generation within max_seq_len {self.max_seq_len}"
            )
        self.prefix_cache = bool(cfg.prefix_cache)
        self.suffix_buckets = _check_prefix_cache(
            self.prefix_cache, cfg.suffix_buckets, self.buckets)
        self._prefill_widths = tuple(
            sorted(set(self.buckets) | set(self.suffix_buckets)))
        self.spill_blocks = _check_spill(
            cfg.spill_blocks, cfg.spill_codec, self.prefix_cache)
        self.spill_codec = str(cfg.spill_codec or "fp")
        self.kv_quant = _check_kv_quant(cfg.kv_quant, self.spill_codec)
        self.role = _check_role(cfg.role, self.prefix_cache, cfg.speculation)
        if static_batching:
            for bad, what, why in (
                (self.role != "unified", f"serving.role={self.role!r}",
                 "the static baseline forms whole batches and runs them "
                 "to completion in one engine — there is no phase "
                 "boundary to split"),
                (self.kv_quant != "off",
                 f"serving.kv_quant={self.kv_quant!r}",
                 "the static baseline is the exact-numerics anchor, and a "
                 "quantized pool perturbs logits"),
                (bool(self.spill_blocks), "serving.spill_blocks",
                 "the host tier carries warm prefixes ACROSS batches, the "
                 "very reuse the static baseline excludes"),
                (self.prefix_cache, "serving.prefix_cache",
                 "cross-batch KV reuse would confound what the static "
                 "baseline isolates"),
            ):
                if bad:
                    raise NotImplementedError(
                        f"{what} x static_batching: {why} — compare against "
                        "the continuous engine instead")
        S, bs = int(cfg.slots), int(cfg.block_size)
        self.slots_n, self.block_size = S, bs
        self.attn_kernel = str(cfg.attn_kernel)
        if self.attn_kernel not in ("reference", "pallas"):
            raise ValueError(
                "serving.attn_kernel must be 'reference' or 'pallas', got "
                f"{self.attn_kernel!r}"
            )
        self.spec_k = _check_speculation(cfg.speculation, bs,
                                         self.attn_kernel)
        # One draft window wider than max_seq_len needs, as in the
        # reference: a verify step writes up to spec_k positions past the
        # cursor, into columns that stay on the null block.
        self.pages = blocks_for(self.max_seq_len + self.spec_k, bs)

        # --- size the pool from the device-memory budget -----------------
        # Per-block bytes of every layer's pool tensors: layers x {k, v} x
        # bs x kv_heads x D x itemsize, plus the f32 scale pools under int8
        # — what the reference measures with a shape-only init probe.
        self._pool_specs = paged_pool_specs(
            model.num_kv_heads, model.head_dim, model.dtype, 1, bs,
            self.kv_quant,
        )
        block_bytes = model.num_layers * sum(
            math.prod(shape) * torch.empty((), dtype=dt).element_size()
            for shape, dt in self._pool_specs.values()
        )
        budget = int(cfg.hbm_budget_mb) * (1 << 20)
        self.num_blocks = budget // block_bytes
        min_blocks = 1 + blocks_for(self.max_seq_len, bs)  # null + 1 request
        if self.num_blocks < min_blocks:
            raise ValueError(
                f"serving.hbm_budget_mb={cfg.hbm_budget_mb} holds "
                f"{self.num_blocks} KV blocks of {block_bytes} B but one "
                f"max_seq_len={self.max_seq_len} request needs "
                f"{min_blocks} — raise the budget or lower max_seq_len"
            )
        self.block_bytes = block_bytes
        self.max_prefills = int(cfg.max_prefills_per_step)
        if self.max_prefills < 0:
            raise ValueError(
                "serving.max_prefills_per_step must be >= 0, got "
                f"{self.max_prefills}"
            )
        self.model = model.to(self.device).eval()
        self.quant_report = (
            quantize_params(self.model, int(cfg.quant_block))
            if cfg.quant == "int8" else None
        )
        self._pools = [
            {
                name: torch.zeros((self.num_blocks,) + tuple(shape[1:]),
                                  dtype=dt, device=self.device)
                for name, (shape, dt) in self._pool_specs.items()
            }
            for _ in range(model.num_layers)
        ]

        # --- host-side scheduler + per-lane operand rows ----------------
        # Host spill store: chain hash -> ("fp", raw block bytes) or
        # ("int8", [(codes, scales) per pool tensor]).
        self._spill_store: dict[bytes, tuple] = {}
        self.spill_stats = {
            "spill_bytes": 0, "promote_bytes": 0,
            "spill_transfers": 0, "promote_transfers": 0,
        }
        self.scheduler = Scheduler(
            S, self._new_pool(self.num_blocks), self.max_seq_len,
            kv_bytes_per_token=self.block_bytes // bs,
            kv_quant=self.kv_quant, role=self.role,
        )
        self._handoffs: list[dict] = []
        self.handoff_stats = {
            "exported": 0, "export_blocks": 0, "export_bytes": 0,
            "adopted": 0, "adopt_blocks": 0, "adopt_bytes": 0,
            "adopt_skipped_blocks": 0, "adopt_fallbacks": 0,
        }
        self._staged_promotes: dict[int, tuple] = {}
        self._table = np.zeros((S, self.pages), np.int32)
        self._lens = np.zeros((S,), np.int32)
        self._tok = np.zeros((S,), np.int32)
        self._temp = np.zeros((S,), np.float32)
        self._top_k = np.zeros((S,), np.int32)
        self._top_p = np.zeros((S,), np.float32)
        self._gens: list[torch.Generator | None] = [None] * S
        self._seed = int(seed)
        self.calls = {"prefill": 0, "decode": 0, "verify": 0}
        # drafted = draft tokens offered to verify, draft_hits = accepted
        # drafts, emitted = tokens verify steps emitted (hits plus one
        # correction or bonus token a lane a step), lane_steps = (lane,
        # verify call) pairs.
        self.spec = {"drafted": 0, "draft_hits": 0, "emitted": 0,
                     "lane_steps": 0}
        # Host wall seconds of each decode (or verify) call, sampled tokens
        # on the host included (the call ends in a device sync either way).
        self.decode_step_s: list[float] = []
        self.step_count = 0
        # Programs readied (``num_compiles``) and the drain flag.
        self._programs: set[str] = set()
        self.draining = False

    def _new_pool(self, num_blocks: int) -> KVBlockPool:
        return KVBlockPool(num_blocks, self.block_size,
                           prefix_cache=self.prefix_cache,
                           spill_blocks=self.spill_blocks,
                           spill_fn=self._spill_out,
                           drop_fn=self._spill_drop)

    # ------------------------------------------------------------------
    # cache plumbing: host arrays in, pool tensors shared across calls
    # ------------------------------------------------------------------

    def _inject(self, table, lens) -> PagedKVCache:
        """The paged cache for one call: host-built page table and cursors
        of the call's batch size over the shared pool tensors."""
        t = np.asarray(table)
        if t.size and (int(t.min()) < 0 or int(t.max()) >= self.num_blocks):
            # An out-of-range block id would read (and write) another
            # request's KV, or fault on the device: the host is the source
            # of truth for tables, so check every one.
            raise ValueError(
                f"page table entry out of range [0, {self.num_blocks}): "
                f"min={int(t.min())} max={int(t.max())}"
            )
        return PagedKVCache(
            self._pools,
            torch.as_tensor(np.array(t, np.int32), device=self.device),
            torch.as_tensor(np.array(lens, np.int32), device=self.device),
            kernel=self.attn_kernel,
        )

    def _host(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _sample_body(self, logits, temp, top_k, top_p, gens) -> np.ndarray:
        """[B, V] fp32 logits -> [B] int32 tokens on the host: argmax for
        rows with temperature 0, else a Gumbel-max draw from the tempered,
        filtered logits with the row's own generator."""
        tok = logits.argmax(dim=-1)
        rows = np.flatnonzero(np.asarray(temp) > 0)
        if rows.size:
            t = self._host(temp)
            tempered = logits / torch.where(t > 0, t, torch.ones_like(t))[:, None]
            filtered = _filter_logits(
                tempered, self._host(top_k), self._host(top_p)
            )
            tiny = torch.finfo(torch.float32).tiny
            for r in rows:
                u = torch.rand(
                    filtered.shape[-1], generator=gens[r], device=self.device
                ).clamp_(min=tiny)
                tok[r] = torch.argmax(filtered[r] - torch.log(-torch.log(u)))
        return tok.to(torch.int32).cpu().numpy()

    @property
    def num_compiles(self) -> int:
        """Distinct programs readied so far (module docstring): the JAX
        engine's compile count on the same config and trace."""
        return len(self._programs)

    def _first_call(self, name: str, t0: float) -> None:
        """Count program ``name`` as readied and register it in the
        telemetry registry on its first call, with that call's seconds (a
        kernel build included)."""
        self._programs.add(name)
        if name not in self._tel.registry:
            self._tel.record_exe(name, None,
                                 compile_s=time.perf_counter() - t0)

    def warmup(self):
        """Ready every program now: build the decode kernel (a CUDA device
        with ``attn_kernel='pallas'``), so the first decode step does not
        pay the ``nvcc`` build, and count the decode step, each prefill
        width and (speculation on) the verify step as readied — the JAX
        engine's compile pin, ``len(prompt_buckets) +
        len(suffix_buckets) + 1`` programs (+1 with speculation), which
        steady traffic never raises."""
        if self.attn_kernel == "pallas" and self.device.type == "cuda":
            from ..ops._build import load

            load("paged_attention")
        self._programs.add("serving_decode")
        if self.spec_k:
            self._programs.add("serving_verify")
        self._programs.update(
            f"serving_prefill_{b}" for b in self._prefill_widths)

    # ------------------------------------------------------------------
    # pool rows as bytes: spill, promote, handoff
    # ------------------------------------------------------------------

    def _pool_leaves(self) -> list[torch.Tensor]:
        """Every pool tensor, layer by layer, names sorted — one order for
        capture and scatter, so a payload's slice k always names the same
        tensor."""
        return [layer[n] for layer in self._pools for n in sorted(layer)]

    def _gather_rows(self, ids) -> torch.Tensor:
        """Pool blocks ``ids`` as raw bytes on the host, ``[n,
        block_bytes]`` uint8: each block's rows of every pool tensor
        concatenated in :meth:`_pool_leaves` order, in ONE device-to-host
        copy."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        parts = [leaf.index_select(0, idx).reshape(len(ids), -1)
                 .view(torch.uint8) for leaf in self._pool_leaves()]
        return torch.cat(parts, dim=1).cpu()

    def _scatter_rows(self, ids, rows: torch.Tensor) -> None:
        """The inverse of :meth:`_gather_rows`: ``rows`` ``[n,
        block_bytes]`` uint8 (on any device) written into pool blocks
        ``ids``, tensor by tensor."""
        idx = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        rows = rows.to(self.device, non_blocking=True)
        off = 0
        for leaf in self._pool_leaves():
            nb = math.prod(leaf.shape[1:]) * leaf.element_size()
            part = rows[:, off:off + nb].contiguous().view(leaf.dtype)
            leaf.index_copy_(0, idx, part.reshape((len(ids),) + leaf.shape[1:]))
            off += nb

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor copied to the device without blocking the host:
        from pinned memory on a CUDA device (the copy is ordered before
        every later kernel on the stream, so the scatter that reads it
        waits for it)."""
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------
    # host spill tier
    # ------------------------------------------------------------------

    def _spill_out(self, pairs: list[tuple[int, bytes]]) -> None:
        """Pool eviction callback: capture the victims' KV into the host
        store BEFORE their blocks can be reused, one copy per eviction
        batch. ``'fp'`` keeps the pool's bytes; ``'int8'`` quantizes each
        pool tensor's rows per 256-element block, the scales beside the
        codes."""
        rows = self._gather_rows([b for b, _ in pairs])
        self.spill_stats["spill_transfers"] += 1
        for i, (_, h) in enumerate(pairs):
            if self.spill_codec == "int8":
                payload, off = [], 0
                for leaf in self._pool_leaves():
                    nb = math.prod(leaf.shape[1:]) * leaf.element_size()
                    vals = rows[i, off:off + nb].view(leaf.dtype).float()
                    off += nb
                    q, scale = block_quantize(
                        _pad_to(vals, _SPILL_QBLOCK), _SPILL_QBLOCK)
                    payload.append((q, scale))
                nbytes = sum(q.numel() + 4 * s.numel() for q, s in payload)
                self._spill_store[h] = ("int8", payload)
            else:
                nbytes = rows.shape[1]
                self._spill_store[h] = ("fp", rows[i].clone())
            self.spill_stats["spill_bytes"] += nbytes

    def _spill_drop(self, chain_hash: bytes) -> None:
        """Pool drop callback: a host node left the trie — release its
        payload."""
        self._spill_store.pop(chain_hash, None)

    def _start_promotions(self, state: RequestState) -> None:
        """Stage ``state``'s promoted blocks: pop their payloads and start
        the host-to-device copies now (non-blocking), parked for the
        scatter in :meth:`_apply_promotions`. ``step()`` stages every
        admitted state before the first prefill, so the copies run under
        the earlier admissions' prefills."""
        pairs = state.promoted
        if not pairs:
            return
        state.promoted = []
        t0 = time.perf_counter()
        entries = [self._spill_store.pop(h) for _, h in pairs]
        codec = entries[0][0]
        if codec == "int8":
            uploads = [
                (self._to_device(torch.stack([e[1][j][0] for e in entries])),
                 self._to_device(torch.stack([e[1][j][1] for e in entries])))
                for j in range(len(entries[0][1]))
            ]
            nbytes = sum(q.numel() + 4 * s.numel() for q, s in uploads)
        else:
            uploads = self._to_device(torch.stack([e[1] for e in entries]))
            nbytes = uploads.numel()
        self.spill_stats["promote_bytes"] += nbytes
        self.spill_stats["promote_transfers"] += 1
        self._staged_promotes[state.request.request_id] = (
            codec, [b for b, _ in pairs], uploads)
        self._tel.hist("promote_stage").record(time.perf_counter() - t0)

    def _apply_promotions(self, state: RequestState) -> None:
        """Scatter ``state``'s staged blocks into the pool, below the row's
        cursor, with the bytes the trie published there (bit for bit under
        ``'fp'``)."""
        t0 = time.perf_counter()
        staged = self._staged_promotes.pop(state.request.request_id, None)
        if staged is None:
            if not state.promoted:
                return
            self._start_promotions(state)
            staged = self._staged_promotes.pop(state.request.request_id)
        codec, ids, uploads = staged
        if codec == "int8":
            idx = torch.as_tensor(np.asarray(ids, np.int64),
                                  device=self.device)
            for leaf, (q, scale) in zip(self._pool_leaves(), uploads):
                n, row = len(ids), math.prod(leaf.shape[1:])
                flat = block_dequantize(q.reshape(-1, _SPILL_QBLOCK),
                                        scale.reshape(-1, 1))
                vals = flat.reshape(n, -1)[:, :row].reshape(
                    (n,) + leaf.shape[1:])
                leaf.index_copy_(0, idx, vals.to(leaf.dtype))
        else:
            self._scatter_rows(ids, uploads)
        self._tel.hist("promote_wait").record(time.perf_counter() - t0)

    def constrain_pool(self, num_blocks: int) -> None:
        """Rebuild the pool with ``num_blocks <= self.num_blocks`` usable
        entries (sizes the device pool below a trace's prefix working set,
        so eviction and spill pressure is real). Only on an idle engine;
        the spill store is cleared with the trie."""
        if self.scheduler.active or self.scheduler.pending:
            raise RuntimeError(
                "constrain_pool with requests queued or in flight"
            )
        if not 2 <= num_blocks <= self.num_blocks:
            raise ValueError(
                f"constrain_pool({num_blocks}): need 2 <= n <= "
                f"{self.num_blocks} (the allocated pool)"
            )
        self.scheduler.pool = self._new_pool(num_blocks)
        self._spill_store.clear()

    def _spill_meta(self) -> dict:
        return {"kv_quant": self.kv_quant, "spill_codec": self.spill_codec,
                "block_bytes": self.block_bytes}

    def save_spill_store(self, path: str) -> int:
        """Persist the host spill tier (the trie's host nodes and their
        payloads) to ``path``; device blocks and live requests are not
        saved. Returns the number of nodes written."""
        return self.scheduler.pool.save_host_store(
            path, self._spill_store, meta=self._spill_meta())

    def load_spill_store(self, path: str) -> int:
        """Restore a :meth:`save_spill_store` file into this engine's host
        tier (root-connected chains, existing hashes win, the
        ``spill_blocks`` budget caps intake); the file's layout must be
        this engine's. Returns the number of chains restored."""
        loaded = self.scheduler.pool.load_host_store(
            path, expect_meta=self._spill_meta())
        self._spill_store.update(loaded)
        return len(loaded)

    # ------------------------------------------------------------------
    # prefill/decode roles: export on the prefill side, adoption on the
    # decode side; the block is the unit, the trie the ledger
    # ------------------------------------------------------------------

    def _queue_handoff(self, state: RequestState, *, written: int) -> None:
        """Prefill side: export the prompt's cached chain (digests and raw
        block bytes), retire the lane WITHOUT finishing the request, and
        park the record on the handoff queue. ``written`` is the count of
        prompt positions whose KV this engine wrote (``len(prompt) - 1``
        on the decode route, which ran no forward). The capture happens
        before ``complete_handoff`` releases the chain."""
        req, slot = state.request, state.slot
        digests, ids = self.scheduler.pool.export_chain(req.prompt)
        rows = self._gather_rows(ids) if ids else None
        payloads = ([] if rows is None
                    else [r.numpy().tobytes() for r in rows])
        nbytes = sum(len(p) for p in payloads)
        self.scheduler.complete_handoff(slot, self.clock(), written=written)
        self._park(slot)
        self._handoffs.append({
            "state": state, "request": req,
            "digests": digests, "payloads": payloads,
        })
        self.scheduler.handoff_queue_depth = len(self._handoffs)
        self.scheduler.handoff_bytes_total += nbytes
        st = self.handoff_stats
        st["exported"] += 1
        st["export_blocks"] += len(ids)
        st["export_bytes"] += nbytes
        self._event("request_handoff", state, slot=slot, blocks=len(ids),
                    kv_bytes=nbytes)

    def take_handoffs(self) -> list[dict]:
        """Drain the handoff queue: each record carries the retired
        ``state``, its ``request``, the chain ``digests`` and the raw block
        ``payloads``."""
        out, self._handoffs = self._handoffs, []
        self.scheduler.handoff_queue_depth = 0
        return out

    def adopt_chain(self, prompt: list[int], payloads: list[bytes], *,
                    offset: int = 0) -> int:
        """Decode side: graft ``payloads`` — raw block bytes for chain
        positions ``offset .. offset+len(payloads)`` of ``prompt`` — into
        this engine's pool and trie, so the request's :meth:`submit` admits
        as a (near-)full prefix hit. Positions the trie already holds are
        skipped; a stale slice or a full pool adopts nothing (the request
        then prefills cold). A payload of the wrong size raises before any
        device write. Returns the blocks adopted."""
        digests = chain_digests(prompt, self.block_size)
        k_end = offset + len(payloads)
        if k_end > len(digests):
            raise ValueError(
                f"adopt_chain: {len(payloads)} payload blocks at offset "
                f"{offset} overrun the prompt's {len(digests)}-block chain"
            )
        for raw in payloads:
            if len(raw) != self.block_bytes:
                raise ValueError(
                    f"handoff block payload is {len(raw)} bytes; this "
                    f"pool's blocks are {self.block_bytes} — sender "
                    "kv_quant/model layout differs"
                )
        pool = self.scheduler.pool
        st = self.handoff_stats
        m = pool.match_digests(digests[:k_end])
        if m < offset:
            st["adopt_fallbacks"] += 1
            return 0
        if m >= k_end:
            st["adopt_skipped_blocks"] += len(payloads)
            return 0
        blocks = pool.alloc(k_end - m)
        if blocks is None:
            st["adopt_fallbacks"] += 1
            return 0
        rows = torch.stack([
            torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            for raw in payloads[m - offset:]
        ])
        self._scatter_rows(blocks, self._to_device(rows))
        pool.adopt_chain(prompt, blocks, start=m)
        nbytes = rows.numel()
        st["adopted"] += 1
        st["adopt_blocks"] += len(blocks)
        st["adopt_bytes"] += nbytes
        st["adopt_skipped_blocks"] += m - offset
        self.scheduler.handoff_bytes_total += nbytes
        return len(blocks)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def bucket_of(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest "
            f"serving.prompt_buckets entry {self.buckets[-1]}"
        )

    def suffix_bucket_of(self, suffix_len: int) -> int:
        """Smallest prefill width (suffix or prompt bucket) that fits an
        uncached suffix."""
        for b in self._prefill_widths:
            if suffix_len <= b:
                return b
        raise ValueError(
            f"suffix length {suffix_len} exceeds the largest prefill "
            f"width {self._prefill_widths[-1]}"
        )

    def prefix_match_len(self, prompt: list[int]) -> int:
        """Tokens of ``prompt`` whose KV this engine already caches (0 with
        the cache off)."""
        return self.scheduler.pool.match_len(list(prompt))

    def prefix_match_digests(self, digests: list[bytes]) -> int:
        """Cached-token count from pre-hashed chain digests
        (``scheduler.chain_digests``): the router hashes a prompt once and
        probes every replica with it. Matches through the host tier, like
        admission."""
        return self.scheduler.pool.match_digests(digests) * self.block_size

    def prefix_digest_summary(self, limit: int = 0) -> list[bytes]:
        """The trie's digest set (MRU first, capped at ``limit``) a fleet
        worker ships in its heartbeat (``KVBlockPool.digest_summary``).
        Empty with the cache off."""
        return self.scheduler.pool.digest_summary(limit)

    def drain(self) -> None:
        """Cut intake: everything already accepted — queued and in flight
        — runs to completion with the same tokens, and every new
        :meth:`submit` is refused by name. Once :meth:`run` reaches idle
        the pool's free list is back to the empty engine's and the replica
        can leave the fleet."""
        self.draining = True

    def submit(self, request: Request,
               now: float | None = None) -> RequestState:
        """Enqueue one request (``now`` overrides the arrival stamp: the
        router stamps arrivals with its own clock)."""
        if self.draining:
            raise RuntimeError(
                "ServingEngine is draining: in-flight requests run to "
                "completion but new submissions are rejected — route to "
                "another replica"
            )
        self.bucket_of(len(request.prompt))  # fail before enqueueing
        if self.spec_k and request.temperature > 0:
            raise NotImplementedError(
                "serving.speculation x sampled request (temperature="
                f"{request.temperature}): speculative serving is "
                "greedy-only — submit temperature=0 requests or set "
                "serving.speculation='off'"
            )
        return self.scheduler.submit(
            request, self.clock() if now is None else now
        )

    def _event(self, name: str, state: RequestState, **fields):
        rec = serving_event(
            name, self.step_count,
            request_id=state.request.request_id, **fields,
        )
        self._emit(rec)
        self._tel.note_event(rec)

    def _park(self, slot: int) -> None:
        """Point an emptied lane at the null block with cursor 0."""
        self._temp[slot] = 0.0
        self._lens[slot] = 0
        self._table[slot] = 0
        self._gens[slot] = None

    def _finish_if_done(self, state: RequestState, tok: int) -> bool:
        req = state.request
        done = len(state.generated) >= req.max_new_tokens or (
            self.cfg.eos_id >= 0 and tok == self.cfg.eos_id
        )
        if done:
            slot = state.slot
            self.scheduler.complete(slot, self.clock())
            self._park(slot)
            self._event(
                "request_completed", state,
                new_tokens=len(state.generated), slot=slot,
            )
        return done

    def _note_first_token(self, state: RequestState, now: float):
        if state.first_token_s is not None:
            return
        state.first_token_s = now
        self._event(
            "first_token", state, slot=state.slot,
            ttft_s=round(now - state.arrival_s, 6),
        )
        self._tel.hist("ttft").record(now - state.arrival_s)

    def _admit_one(self, state: RequestState):
        req, slot = state.request, state.slot
        # Promote FIRST, on either route: a full-prefix hit can ride
        # through spilled nodes too.
        self._apply_promotions(state)
        row = np.zeros((self.pages,), np.int32)
        chain = state.cached_blocks + state.blocks  # logical block order
        row[: len(chain)] = chain
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_lane_seed(self._seed, req.request_id))
        self._table[slot] = row
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        if state.decode_route:
            if self.role == "prefill":
                # The whole exportable chain is resident: hand off with no
                # forward; the last prompt token's KV was never written.
                self._queue_handoff(state, written=len(req.prompt) - 1)
                return
            # Full-prefix hit: the match is capped below the last prompt
            # token, so the next decode step writes that token's KV at
            # position len-1, in the request's OWN block, and samples the
            # first new token.
            self._lens[slot] = len(req.prompt) - 1
            self._tok[slot] = req.prompt[-1]
            self._gens[slot] = gen
            return
        off = state.cached_len  # 0 = cold, else suffix-only prefill
        suffix = req.prompt[off:]
        tokens = np.zeros((1, state.bucket), np.int64)
        tokens[0, : len(suffix)] = suffix  # RIGHT-padded to the width
        # The same prefill body at any offset: the cursor at off puts the
        # positions, the causal mask over the cached columns and the KV
        # scatter (row[off // bs:], the request's own blocks) in place.
        t0 = time.perf_counter()
        out = prefill(self.model, self._inject(row[None], [off]),
                      self._host(tokens))
        self.calls["prefill"] += 1
        if self.role == "prefill":
            # Publish the prompt's blocks (their KV is final) and hand off
            # instead of decoding; the decode engine samples the first
            # token from the same (seed, request_id) generator.
            self._first_call(f"serving_prefill_{state.bucket}", t0)
            self.scheduler.publish_prefix(state, len(req.prompt))
            self._queue_handoff(state, written=len(req.prompt))
            return
        tok = int(self._sample_body(
            logits_at(out, [len(suffix) - 1]), self._temp[slot:slot + 1],
            self._top_k[slot:slot + 1], self._top_p[slot:slot + 1], [gen],
        )[0])
        self._first_call(f"serving_prefill_{state.bucket}", t0)
        now = self.clock()
        state.generated.append(tok)
        state.token_times_s.append(now)
        # Arm the lane for decode: the KV holds len real positions (pad
        # writes beyond len are masked and overwritten in place later).
        self._lens[slot] = len(req.prompt)
        self._tok[slot] = tok
        self._gens[slot] = gen
        self._note_first_token(state, now)
        # Publish the prompt's full blocks now that their KV is final:
        # later arrivals in the same wave already hit them.
        self.scheduler.publish_prefix(state, len(req.prompt))
        self._finish_if_done(state, tok)

    def step(self) -> bool:
        """One engine iteration: admit (+prefill) into free lanes, then one
        decode (or verify) call for the whole batch. Returns False when
        idle."""
        self.step_count += 1
        tel = self._tel
        now = self.clock()
        with tel.span("schedule", step=self.step_count) as sp:
            admitted = (
                [] if self.static_batching and self.scheduler.active
                else self.scheduler.admit(
                    now, self.bucket_of, max_admit=self.max_prefills,
                    suffix_bucket_of=(
                        self.suffix_bucket_of if self.prefix_cache else None
                    ),
                    cover_tokens=self.pages * self.block_size,
                )
            )
            if admitted:
                sp.set(request_ids=[s.request.request_id for s in admitted])
        # Start every admitted state's promotion copies before the first
        # prefill, so they run under the earlier admissions' prefills.
        for state in admitted:
            self._start_promotions(state)
        for state in admitted:
            extra = {}
            if self.prefix_cache:
                extra["cached_tokens"] = state.cached_len
                tel.hist("cached_prefill_skip").record(
                    float(state.cached_len))
            self._event(
                "request_admitted", state, slot=state.slot,
                bucket=state.bucket, blocks=len(state.blocks),
                queue_s=round(now - state.arrival_s, 6), **extra,
            )
            tel.hist("queue_wait").record(now - state.arrival_s)
            with tel.span("prefill", step=self.step_count,
                          request_id=state.request.request_id,
                          bucket=state.bucket):
                self._admit_one(state)
        if self.gauge_every and self.step_count % self.gauge_every == 0:
            gauges = self.scheduler.gauges(self.clock())
            if self.spec_k and self.spec["drafted"]:
                gauges["spec_accept_rate"] = round(
                    self.spec["draft_hits"] / self.spec["drafted"], 4)
            rec = serving_gauges(self.step_count, **gauges)
            self._emit(rec)
            tel.note_event(rec)
            tel.note_gauges(gauges)
        active = self.scheduler.active
        if not active:
            return not self.scheduler.idle
        toks = dlens = None
        if self.spec_k:
            toks = np.zeros((self.slots_n, self.spec_k + 1), np.int32)
            toks[:, 0] = self._tok
            dlens = np.zeros((self.slots_n,), np.int32)
            for state in active:
                d = self._draft_for(state)
                if d:
                    toks[state.slot, 1:1 + len(d)] = d
                    dlens[state.slot] = len(d)
        if dlens is not None and dlens.any():
            self._verify_batch(active, toks, dlens)
        else:
            # Speculation off, or no lane found a draft: the L=1 call
            # (verify with empty drafts would give the same tokens).
            self._decode_batch(active)
        return not self.scheduler.idle

    def _span_args(self, active, **args) -> dict:
        args = {"step": self.step_count, "batch": len(active), **args}
        if self._tel.enabled:
            args["request_ids"] = [s.request.request_id for s in active]
        return args

    def _decode_batch(self, active):
        """One decode call (L=1) for the whole batch."""
        with self._tel.span("decode", **self._span_args(active)):
            cache = self._inject(self._table, self._lens)
            t0 = time.perf_counter()
            logits = decode_step(
                self.model, cache,
                self._host(self._tok[:, None].astype(np.int64))
            )
            # The sync on the sampled tokens is inside the span.
            tok = self._sample_body(
                logits, self._temp, self._top_k, self._top_p, self._gens
            )
            self.decode_step_s.append(time.perf_counter() - t0)
        self._first_call("serving_decode", t0)
        self.calls["decode"] += 1
        now = self.clock()
        for state in active:
            slot = state.slot
            t = int(tok[slot])
            state.generated.append(t)
            state.token_times_s.append(now)
            self._lens[slot] += 1
            self._tok[slot] = t
            self._note_first_token(state, now)  # decode-route admissions
            self._finish_if_done(state, t)

    def _draft_for(self, state: RequestState) -> list[int]:
        """Up to ``spec_k`` draft tokens for one lane, by n-gram lookup
        over the request's own prompt and generated tokens."""
        return ngram_draft(
            state.request.prompt + state.generated, self.spec_k
        )

    def _verify_batch(self, active, toks, dlens):
        """One verify call: score all K+1 positions a lane, accept each
        lane's longest draft prefix that matches the greedy continuation
        plus the correction (or bonus) token, and rewind past rejected
        drafts by not advancing the cursor: the KV written for them is
        overwritten by the next step's own scatter before any read."""
        tel = self._tel
        with tel.span("decode", **self._span_args(
                active, speculative=True, drafted=int(dlens.sum()))) as sp:
            cache = self._inject(self._table, self._lens)
            t0 = time.perf_counter()
            greedy = verify_step(self.model, cache,
                                 self._host(toks.astype(np.int64)))
            greedy = greedy.cpu().numpy()
            self.decode_step_s.append(time.perf_counter() - t0)
            self.calls["verify"] += 1
            now = self.clock()
            runs = np.cumprod(
                toks[:, 1:] == greedy[:, :-1], axis=1
            ).sum(axis=1)
            accepted_toks = greedy.tolist()
            emitted = hits = 0
            for state in active:
                slot = state.slot
                req = state.request
                # Clipped so a lane never emits past max_new_tokens, which
                # keeps every accepted position inside its reservation.
                limit = min(int(dlens[slot]),
                            req.max_new_tokens - len(state.generated) - 1)
                m = min(int(runs[slot]), limit)
                acc = accepted_toks[slot][:m + 1]
                # EOS inside an accepted run ends the request there.
                if self.cfg.eos_id >= 0 and self.cfg.eos_id in acc:
                    acc = acc[: acc.index(self.cfg.eos_id) + 1]
                state.generated.extend(acc)
                state.token_times_s.extend([now] * len(acc))
                self._lens[slot] += len(acc)
                self._tok[slot] = acc[-1]
                self._note_first_token(state, now)
                emitted += len(acc)
                hits += len(acc) - 1 if len(acc) == m + 1 else len(acc)
                tel.hist(SPEC_ACCEPT_HIST).record(float(len(acc)))
                self._finish_if_done(state, acc[-1])
            sp.set(accepted=emitted, draft_hits=hits)
        self._first_call("serving_verify", t0)
        self.spec["drafted"] += int(dlens.sum())
        self.spec["draft_hits"] += hits
        self.spec["emitted"] += emitted
        self.spec["lane_steps"] += len(active)

    def run(self, max_steps: int = 0) -> list[RequestState]:
        """Drain the queue; returns the finished states (submit order)."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps and steps >= max_steps:
                break
        return sorted(
            self.scheduler.finished,
            key=lambda s: s.request.request_id,
        )

    def stats(self) -> dict:
        out = {
            **self.scheduler.stats(),
            "num_blocks": self.num_blocks,
            "block_bytes": self.block_bytes,
            "pages_per_seq": self.pages,
            "prompt_buckets": list(self.buckets),
            "suffix_buckets": list(self.suffix_buckets),
            "num_compiles": self.num_compiles,
            "calls": dict(self.calls),
            "steps": self.step_count,
            "quant": self.quant_report,
            "kv_quant": self.kv_quant,
            "kv_bytes_per_token": self.block_bytes // self.block_size,
            "attn_kernel": self.attn_kernel,
            "max_prefills_per_step": self.max_prefills,
            "draining": self.draining,
            "device": str(self.device),
            "speculation": None if not self.spec_k else {
                "k": self.spec_k,
                **self.spec,
                "verify_calls": self.calls["verify"],
                "accept_rate": (
                    round(self.spec["draft_hits"] / self.spec["drafted"], 4)
                    if self.spec["drafted"] else None
                ),
                "mean_accepted_per_step": (
                    round(self.spec["emitted"] / self.spec["lane_steps"], 4)
                    if self.spec["lane_steps"] else None
                ),
            },
        }
        if self.prefix_cache and self.spill_blocks:
            out["prefix_cache"].update({
                "spill_codec": self.spill_codec,
                "spill_store_blocks": len(self._spill_store),
                **self.spill_stats,
            })
        if self.role != "unified":
            out["handoff"] = dict(self.handoff_stats)
        return out
