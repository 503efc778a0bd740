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

This slice ports the engine core. The prefix cache, host spill tier,
speculation, disaggregation roles, int8 weight quantization, replicas,
router, socket fleet, static batching and the telemetry bundle are refused
by name (:func:`check_serving_composition`, :class:`ServingEngine`).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..generate import _filter_logits, decode_step, logits_at, prefill
from ..metrics import serving_event, serving_gauges
from ..models.transformer import PagedKVCache, paged_pool_specs
from .scheduler import KVBlockPool, Request, RequestState, Scheduler, blocks_for

KV_QUANT_MODES = ("off", "int8")
SERVABLE_MODELS = ("gpt2", "llama")
ROUTER_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")
SHED_POLICIES = ("off", "deadline")
SERVING_ROLES = ("unified", "prefill", "decode")
SERVE_FAULT_KINDS = (
    "worker_crash", "worker_hang", "conn_drop", "heartbeat_stall"
)
_NOT_PORTED = "not yet ported to distributeddeeplearning_tpu_torch"


# ---------------------------------------------------------------------------
# Composition fences: the reference's, unchanged, then the port's refusals
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


def _refuse_unported(s) -> None:
    """Refuse, by name, every serving knob whose feature this slice has not
    ported — a config that asks for one must not silently get the core.
    Knobs that build on the prefix cache are named before it."""
    refused = (
        (s.quant != "none", f"serving.quant={s.quant!r} "
         "(int8 weight quantization)"),
        (str(s.speculation) != "off",
         f"serving.speculation={s.speculation!r} (speculative decoding)"),
        (str(s.role) != "unified",
         f"serving.role={s.role!r} (disaggregated prefill/decode)"),
        (int(s.prefill_replicas) > 0, "serving.prefill_replicas"),
        (bool(s.spill_blocks), "serving.spill_blocks (host spill tier)"),
        (bool(s.suffix_buckets), "serving.suffix_buckets"),
        (bool(s.prefix_cache), "serving.prefix_cache=True (prefix cache)"),
        (int(s.replicas) > 1,
         f"serving.replicas={s.replicas} (replica router)"),
    )
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} {_NOT_PORTED}")


def check_serving_composition(cfg, *, fleet: int = 0) -> None:
    """Config-time composition fences for ``serve`` (fail BY NAME before any
    build): every fence of the JAX package's engine, unchanged — including
    ``pallas x block_size % 8``, which the CUDA kernel would not need — then
    the refusals of what is not ported. ``cfg`` is the full Config."""
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
                "fleet needs at least one decode replica"
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
    # --- the port's refusals ---------------------------------------------
    if fleet:
        raise NotImplementedError(f"serve --fleet {fleet} {_NOT_PORTED}")
    if cfg.telemetry.enabled:
        raise NotImplementedError(f"telemetry.enabled {_NOT_PORTED}")
    _refuse_unported(s)


def _lane_seed(seed: int, request_id: int) -> int:
    """The per-request sampling seed: ``(seed, request_id)`` packed into
    one 64-bit integer."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(request_id) & 0xFFFFFFFF)


class ServingEngine:
    """Continuous batching over ``cfg.slots`` decode lanes.

    ``submit()`` enqueues requests; every ``step()`` retires finished
    lanes, admits from the queue (one bucketed prefill per admission), and
    runs ONE decode call for the whole batch. ``run()`` drains to idle.

    ``model`` is a GPT-2 or a Llama of this package with its weights
    loaded; the engine moves it to ``device`` (``None`` = the GPU; the CPU
    only when asked). ``cfg`` is a ``ServingConfig``. ``clock`` is injectable for
    deterministic tests; ``emit`` receives ``metrics.serving_event``
    records (default: collected on ``self.events``).
    """

    def __init__(self, model, cfg, *, emit=None, clock=time.monotonic,
                 seed: int = 0, static_batching: bool = False,
                 telemetry=None, device=None):
        if getattr(model, "attn_impl", "xla") != "xla":
            raise NotImplementedError(
                f"serving x attn_impl={model.attn_impl!r} (see "
                "check_serving_composition)"
            )
        if static_batching:
            raise NotImplementedError(f"static_batching {_NOT_PORTED}")
        if telemetry is not None:
            raise NotImplementedError(f"serving telemetry {_NOT_PORTED}")
        _check_kv_quant(cfg.kv_quant, cfg.spill_codec)
        _refuse_unported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.clock = clock
        self.events: list[dict] = []
        self._emit = emit if emit is not None else self.events.append
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
        self.kv_quant = str(cfg.kv_quant)
        S, bs = int(cfg.slots), int(cfg.block_size)
        self.slots_n, self.block_size = S, bs
        # Same page-table width as the reference, blocks_for(max_seq_len +
        # spec_k); spec_k is 0 here (speculation is not ported).
        self.pages = blocks_for(self.max_seq_len, bs)

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
        self.attn_kernel = str(cfg.attn_kernel)
        if self.attn_kernel not in ("reference", "pallas"):
            raise ValueError(
                "serving.attn_kernel must be 'reference' or 'pallas', got "
                f"{self.attn_kernel!r}"
            )
        self.max_prefills = int(cfg.max_prefills_per_step)
        if self.max_prefills < 0:
            raise ValueError(
                "serving.max_prefills_per_step must be >= 0, got "
                f"{self.max_prefills}"
            )
        self.model = model.to(self.device).eval()
        self._pools = [
            {
                name: torch.zeros((self.num_blocks,) + tuple(shape[1:]),
                                  dtype=dt, device=self.device)
                for name, (shape, dt) in self._pool_specs.items()
            }
            for _ in range(model.num_layers)
        ]

        # --- host-side scheduler + per-lane operand rows ----------------
        self.scheduler = Scheduler(
            S, KVBlockPool(self.num_blocks, bs), self.max_seq_len,
            kv_bytes_per_token=self.block_bytes // bs,
            kv_quant=self.kv_quant, role="unified",
        )
        self._table = np.zeros((S, self.pages), np.int32)
        self._lens = np.zeros((S,), np.int32)
        self._tok = np.zeros((S,), np.int32)
        self._temp = np.zeros((S,), np.float32)
        self._top_k = np.zeros((S,), np.int32)
        self._top_p = np.zeros((S,), np.float32)
        self._gens: list[torch.Generator | None] = [None] * S
        self._seed = int(seed)
        self.calls = {"prefill": 0, "decode": 0}
        # Host wall seconds of each decode call, sampled tokens on the host
        # included (the call ends in a device sync either way).
        self.decode_step_s: list[float] = []
        self.step_count = 0

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

    def warmup(self):
        """Build the decode kernel now (a CUDA device with
        ``attn_kernel='pallas'``), so the first decode step does not pay
        the ``nvcc`` build."""
        if self.attn_kernel == "pallas" and self.device.type == "cuda":
            from ..ops._build import load

            load("paged_attention")

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

    def submit(self, request: Request,
               now: float | None = None) -> RequestState:
        """Enqueue one request (``now`` overrides the arrival stamp)."""
        self.bucket_of(len(request.prompt))  # fail before enqueueing
        return self.scheduler.submit(
            request, self.clock() if now is None else now
        )

    def _event(self, name: str, state: RequestState, **fields):
        self._emit(serving_event(
            name, self.step_count,
            request_id=state.request.request_id, **fields,
        ))

    def _finish_if_done(self, state: RequestState, tok: int) -> bool:
        req = state.request
        done = len(state.generated) >= req.max_new_tokens or (
            self.cfg.eos_id >= 0 and tok == self.cfg.eos_id
        )
        if done:
            slot = state.slot
            self.scheduler.complete(slot, self.clock())
            self._temp[slot] = 0.0
            self._lens[slot] = 0
            self._table[slot] = 0  # park the lane on the null block
            self._gens[slot] = None
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

    def _admit_one(self, state: RequestState):
        req, slot = state.request, state.slot
        row = np.zeros((self.pages,), np.int32)
        row[: len(state.blocks)] = state.blocks  # logical block order
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_lane_seed(self._seed, req.request_id))
        self._table[slot] = row
        self._temp[slot] = req.temperature
        self._top_k[slot] = req.top_k
        self._top_p[slot] = req.top_p
        tokens = np.zeros((1, state.bucket), np.int64)
        tokens[0, : len(req.prompt)] = req.prompt  # RIGHT-padded
        out = prefill(self.model, self._inject(row[None], [0]),
                      self._host(tokens))
        tok = int(self._sample_body(
            logits_at(out, [len(req.prompt) - 1]), self._temp[slot:slot + 1],
            self._top_k[slot:slot + 1], self._top_p[slot:slot + 1], [gen],
        )[0])
        self.calls["prefill"] += 1
        now = self.clock()
        state.generated.append(tok)
        state.token_times_s.append(now)
        # Arm the lane for decode: the KV holds len real positions (pad
        # writes beyond len are masked and overwritten in place later).
        self._lens[slot] = len(req.prompt)
        self._tok[slot] = tok
        self._gens[slot] = gen
        self._note_first_token(state, now)
        self.scheduler.publish_prefix(state, len(req.prompt))
        self._finish_if_done(state, tok)

    def step(self) -> bool:
        """One engine iteration: admit (+prefill) into free lanes, then one
        decode call for the whole batch. Returns False when idle."""
        self.step_count += 1
        now = self.clock()
        admitted = self.scheduler.admit(
            now, self.bucket_of, max_admit=self.max_prefills,
            cover_tokens=self.pages * self.block_size,
        )
        for state in admitted:
            self._event(
                "request_admitted", state, slot=state.slot,
                bucket=state.bucket, blocks=len(state.blocks),
                queue_s=round(now - state.arrival_s, 6),
            )
            self._admit_one(state)
        if self.gauge_every and self.step_count % self.gauge_every == 0:
            self._emit(serving_gauges(
                self.step_count, **self.scheduler.gauges(self.clock())
            ))
        active = self.scheduler.active
        if active:
            self._decode_batch(active)
        return not self.scheduler.idle

    def _decode_batch(self, active):
        """One decode call (L=1) for the whole batch."""
        cache = self._inject(self._table, self._lens)
        t0 = time.perf_counter()
        logits = decode_step(
            self.model, cache, self._host(self._tok[:, None].astype(np.int64))
        )
        tok = self._sample_body(
            logits, self._temp, self._top_k, self._top_p, self._gens
        )
        self.decode_step_s.append(time.perf_counter() - t0)
        self.calls["decode"] += 1
        now = self.clock()
        for state in active:
            slot = state.slot
            t = int(tok[slot])
            state.generated.append(t)
            state.token_times_s.append(now)
            self._lens[slot] += 1
            self._tok[slot] = t
            self._finish_if_done(state, t)

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
        return {
            **self.scheduler.stats(),
            "num_blocks": self.num_blocks,
            "block_bytes": self.block_bytes,
            "pages_per_seq": self.pages,
            "prompt_buckets": list(self.buckets),
            "calls": dict(self.calls),
            "steps": self.step_count,
            "kv_quant": self.kv_quant,
            "kv_bytes_per_token": self.block_bytes // self.block_size,
            "attn_kernel": self.attn_kernel,
            "max_prefills_per_step": self.max_prefills,
            "device": str(self.device),
        }
