"""Autoregressive generation with a KV cache (GPT-2, Llama, llama_moe), and
the prefill / decode bodies the serving engine shares.

The JAX package compiles the whole loop into one program (a ``lax.scan``
over one-token decode steps); here it runs eagerly under ``torch.no_grad()``
on the device of the model's parameters, with the same stages:

- **prefill** (:func:`_prefill_body`): a contiguous ``KVCache`` of
  ``P + max_new_tokens`` positions (``models.transformer.KVCache``), then
  the whole prompt in one forward (bulk prefill), which samples the first
  new token; capacity-MoE models instead consume the prompt one token at a
  time from position 0 (:func:`uses_bulk_prefill`);
- **decode** (:func:`_decode_body`): one cached forward per position, each
  step's token written into a fixed [B, P + max_new_tokens] buffer on the
  device, so the loop reads nothing on the host.

    tokens = generate(model, prompt, max_new_tokens=32)          # greedy
    tokens = generate(model, prompt, max_new_tokens=32, temperature=0.8,
                      generator=torch.Generator(device).manual_seed(0))

Uneven prompts are left-padded (:func:`pad_prompts`, ``prompt_lens``): the
cache hides each row's pad columns and counts its positions from its first
real token, HF's left-padding semantics. The cache's attention is plain
torch whatever the model's ``attn_impl``, as the reference decodes on its
xla core. Greedy tokens match the reference exactly; sampled tokens match it
in distribution only, because torch cannot replay JAX's ``fold_in`` key
chain (as in ``serving/engine.py``).

The serving engine runs :func:`prefill` and :func:`decode_step` against its
paged cache, whose pools the forward updates in place (the engine owns the
paged cursors).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .models.transformer import KVCache
from .ops.chunked_xent import is_chunked_head


def _logits_of(out) -> torch.Tensor:
    """Full-logits or chunked-head model output -> [B, L, V] fp32 logits."""
    if is_chunked_head(out):
        logits = (out["hidden"] @ out["emb"].t()).float()
        if "bias" in out:
            logits = logits + out["bias"]
        return logits
    return out


def _filter_logits(logits, top_k, top_p):
    """Top-k + nucleus (top-p) filtering, [B, V] -> [B, V] with excluded
    entries at -inf. Expects TEMPERED logits. ``top_k`` / ``top_p`` are
    scalars or [B] tensors (0 = off), sharing one descending sort."""
    B, V = logits.shape
    dev = logits.device
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    # top-k threshold: the kth-largest logit (k clamped into [0, V]).
    k = torch.clamp(torch.as_tensor(top_k, device=dev).expand(B), 0, V)[:, None]
    kth = torch.gather(sorted_desc, 1, torch.clamp(k - 1, min=0).long())
    neg_inf = torch.full_like(kth, float("-inf"))
    thresh_k = torch.where(k > 0, kth, neg_inf)
    # nucleus threshold: smallest logit of the minimal prefix whose
    # cumulative probability reaches top_p (first token always kept).
    p = torch.as_tensor(top_p, dtype=logits.dtype, device=dev).expand(B)[:, None]
    probs = torch.softmax(sorted_desc, dim=-1)
    keep_sorted = torch.cumsum(probs, dim=-1) - probs < p
    thresh_p = torch.where(
        keep_sorted, sorted_desc, torch.full_like(sorted_desc, float("inf"))
    ).amin(dim=-1, keepdim=True)
    thresh_p = torch.where(p > 0, thresh_p, neg_inf)
    return torch.where(
        logits < torch.maximum(thresh_k, thresh_p),
        torch.full_like(logits, float("-inf")), logits,
    )


@torch.no_grad()
def prefill(model, cache, tokens):
    """THE prefill body: run ``tokens`` [B, P] through the model against
    ``cache`` and return the model's raw output (logits or chunked head).
    A contiguous ``KVCache`` is written at its cursor, which then advances
    by P (the reference's mutable cache). A paged cache is written in place
    at the rows' cursors, which the caller owns: a nonzero cursor prefills
    positions ``off .. off+P-1``."""
    out = model(tokens, cache)
    if isinstance(cache, KVCache):
        cache.cache_index += tokens.shape[1]
    return out


@torch.no_grad()
def decode_step(model, cache, tok):
    """THE one-token decode body: ``tok`` [B, 1] -> logits [B, V] at the
    new position."""
    return _logits_of(prefill(model, cache, tok))[:, -1, :]


@torch.no_grad()
def verify_step(model, cache, toks):
    """THE batched draft-and-verify body: ``toks`` [B, L] (each row's last
    accepted token, then L-1 drafted ones) through the same bulk-write path
    as :func:`prefill`; returns the argmax at every position, ``greedy``
    [B, L] int32: ``greedy[:, i]`` is the greedy continuation of the
    stream ending at ``toks[:, i]``. L == 1 is the greedy half of
    :func:`decode_step`."""
    return _logits_of(prefill(model, cache, toks)).argmax(-1).to(torch.int32)


def logits_at(out, pos) -> torch.Tensor:
    """Model output -> [B, V] fp32 logits at per-row position ``pos`` [B].
    For chunked-head output the hidden row is sliced before the head
    matmul, so the [B, P, V] logits never materialize."""
    idx = torch.as_tensor(pos, device=_first(out).device).long()
    rows = torch.arange(idx.shape[0], device=idx.device)
    if is_chunked_head(out):
        hidden = out["hidden"][rows, idx][:, None]
        return _logits_of(dict(out, hidden=hidden))[:, -1, :]
    return out[rows, idx].float()


def _first(out):
    return out["hidden"] if is_chunked_head(out) else out


def _make_pick(temperature, top_k, top_p, sample, filtered, generator):
    """[B, V] logits -> [B] tokens: argmax, or a Gumbel-max draw from the
    tempered (then filtered: HF's warper order) logits with ``generator``,
    the reference's ``jax.random.categorical``."""
    def pick(logits):
        if not sample:
            return logits.argmax(dim=-1)
        logits = logits / temperature
        if filtered:
            logits = _filter_logits(logits, top_k, top_p)
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u.clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    return pick


def new_cache(model, batch: int, total: int, starts) -> KVCache:
    """A zeroed ``KVCache`` of ``total`` positions for ``model``, in its
    compute dtype on its parameters' device, with ``starts`` ([B] left-pad
    counts)."""
    device = next(model.parameters()).device
    return KVCache.empty(model.num_layers, batch, total, model.num_kv_heads,
                         model.head_dim, model.dtype, device, start=starts)


@torch.no_grad()
def _prefill_body(model, prompt, pick, starts, max_new_tokens,
                  bulk_prefill):
    """Stage 1: the cache, the token buffer and (bulk) the whole prompt in
    one forward. Returns ``(buf, cache)``; the matching decode start is
    ``P`` for bulk prefill, else ``0``."""
    B, P = prompt.shape
    cache = new_cache(model, B, P + max_new_tokens, starts)
    buf = torch.cat([prompt, prompt.new_zeros(B, max_new_tokens)], dim=1)
    if bulk_prefill:
        out = prefill(model, cache, prompt)
        if is_chunked_head(out):
            # Only the last position feeds sampling: slice the hidden
            # before the head matmul would materialize [B, P, V] logits.
            out = dict(out, hidden=out["hidden"][:, -1:])
        buf[:, P] = pick(_logits_of(out)[:, -1, :])
    # else: one-token prefill (capacity MoE: a bulk prefill routes the
    # whole prompt through expert capacity at once and may drop tokens a
    # one-token stream would keep); the decode stage consumes the prompt
    # one token at a time from position 0.
    return buf, cache


@torch.no_grad()
def _decode_body(model, buf, cache, pick, P, total, loop_start):
    """Stage 2: one cached forward per position from ``loop_start`` to
    ``total - 2``, each writing the next token into ``buf`` (in place);
    positions inside the prompt keep the prompt's token."""
    for i in range(loop_start, total - 1):
        logits = decode_step(model, cache, buf[:, i:i + 1])
        if i + 1 >= P:
            buf[:, i + 1] = pick(logits)
    return buf


def uses_bulk_prefill(model) -> bool:
    """THE gate deciding bulk vs one-token prefill: capacity-MoE models
    keep the one-token stream, since bulk routing of a whole prompt can
    drop tokens at expert capacity and change decode numerics."""
    return not hasattr(model, "num_experts")


def pad_prompts(prompts, pad_id: int = 0):
    """Left-pad a list of uneven token sequences into ([B, P] int32 array,
    [B] lengths) for :func:`generate(prompt_lens=...)`: every row's real
    content is right-aligned (HF's left-padding layout)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    if (lens == 0).any():
        raise ValueError("empty prompt in batch")
    P = int(lens.max())
    out = np.full((len(prompts), P), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, P - len(p):] = np.asarray(p, np.int32)
    return out, lens


def _ints(x, device) -> torch.Tensor:
    """Token ids or lengths (a tensor, an array or nested lists) as an
    int64 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.int64)


def _prep(model, prompt, max_new_tokens, temperature, top_k, top_p,
          generator, prompt_lens):
    """Validation and operand packing shared by :func:`generate` and
    :func:`decode_bench`: ``(prompt on the model's device [B, P] int64,
    starts [B], pick)``."""
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature>0) requires generator")
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError("top_k/top_p only apply when sampling")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    device = next(model.parameters()).device
    prompt = _ints(prompt, device)
    B, P = prompt.shape
    if prompt_lens is None:
        starts = torch.zeros(B, dtype=torch.int64, device=device)
    else:
        lens = _ints(prompt_lens, device)
        if tuple(lens.shape) != (B,):
            raise ValueError(
                f"prompt_lens must be [batch]={B}, got {tuple(lens.shape)}")
        starts = P - lens
    pick = _make_pick(temperature if temperature > 0 else 1.0, top_k, top_p,
                      temperature > 0.0, bool(top_k or top_p), generator)
    return prompt, starts, pick


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0, generator=None,
             prompt_lens=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` after ``prompt`` [B, P] (ints).

    ``temperature=0`` is greedy argmax; ``>0`` samples with ``generator``
    (a ``torch.Generator`` on the model's device, required), optionally
    restricted to the ``top_k`` highest logits and/or the ``top_p``
    nucleus. Returns the full [B, P + max_new_tokens] int32 buffer on the
    model's device.

    ``prompt_lens`` ([B] ints) batches UNEVEN prompts: ``prompt`` must then
    be LEFT-padded (row b's real tokens are its last ``prompt_lens[b]``,
    :func:`pad_prompts`); attention never sees the pad columns and
    positions are per row."""
    prompt, starts, pick = _prep(model, prompt, max_new_tokens, temperature,
                                 top_k, top_p, generator, prompt_lens)
    bulk = uses_bulk_prefill(model)
    P = prompt.shape[1]
    buf, cache = _prefill_body(model, prompt, pick, starts, max_new_tokens,
                               bulk)
    buf = _decode_body(model, buf, cache, pick, P, P + max_new_tokens,
                       P if bulk else 0)
    return buf.to(torch.int32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def decode_bench(model, prompt, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 generator=None, prompt_lens=None, reps: int = 3):
    """Generation throughput with prefill and decode timed SEPARATELY:
    ``(tokens, record)``, the record under the reference's keys.

    Prefill is one batched forward over the whole prompt; decode is
    ``max_new_tokens - 1`` sequential one-token steps. The headline is
    ``decode_tokens_per_sec``, generated tokens over the median decode-loop
    time, with the prefill rate and the blended end-to-end rate as
    separate fields.

    One warm-up run, then ``reps`` (>= 3) timed runs of each stage, each
    stage bounded by a device synchronize on a card; medians reported.
    Every run starts from ``generator``'s state at the call, so ``tokens``
    equal :func:`generate`'s for the same arguments. (The reference also
    checks that no stage recompiled inside the timed window; eager torch
    compiles nothing, so there is nothing to check.)"""
    if max_new_tokens < 2:
        raise ValueError("decode_bench needs max_new_tokens >= 2 "
                         "(at least one per-token decode step)")
    if reps < 3:
        raise ValueError("decode_bench needs reps >= 3 for a stable median")
    prompt, starts, pick = _prep(model, prompt, max_new_tokens, temperature,
                                 top_k, top_p, generator, prompt_lens)
    bulk = uses_bulk_prefill(model)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    loop_start = P if bulk else 0
    device = prompt.device
    rng_state = None if generator is None else generator.get_state()

    def run():
        if rng_state is not None:
            generator.set_state(rng_state)
        _sync(device)
        t0 = time.perf_counter()
        buf, cache = _prefill_body(model, prompt, pick, starts,
                                   max_new_tokens, bulk)
        _sync(device)
        t1 = time.perf_counter()
        buf = _decode_body(model, buf, cache, pick, P, total, loop_start)
        _sync(device)
        return buf, t1 - t0, time.perf_counter() - t1

    tokens, _, _ = run()  # warm-up: kernels' first launches, allocations
    prefill_s, decode_s = [], []
    for _ in range(reps):
        tokens, tp, td = run()
        prefill_s.append(tp)
        decode_s.append(td)

    # Numerators: decode counts GENERATED tokens only. Bulk prefill emits
    # the first new token, so the loop generates max_new - 1; the one-token
    # prefill path (capacity MoE) generates all max_new inside the loop,
    # but its loop also consumes the prompt, so its rate is conservative.
    decode_steps = total - 1 - loop_start
    generated = B * (max_new_tokens - 1 if bulk else max_new_tokens)
    prompt_tokens = (B * P if prompt_lens is None
                     else int(np.sum(np.asarray(prompt_lens))))
    tp = statistics.median(prefill_s)
    td = statistics.median(decode_s)
    record = {
        "decode_tokens_per_sec": round(generated / td, 2),
        "decode_steps_per_sec": round(decode_steps / td, 2),
        "decode_time_s": round(td, 5),
        "decode_steps_timed": decode_steps,
        "generated_tokens": generated,
        # A one-token prefill (capacity MoE) only allocates the cache: it
        # touches no prompt token, so a prefill rate would mean nothing.
        "prefill_tokens_per_sec": (
            round(prompt_tokens / tp, 2) if bulk else None
        ),
        "prefill_time_s": round(tp, 5),
        "prompt_tokens": prompt_tokens,
        "e2e_tokens_per_sec": round(
            (prompt_tokens + B * max_new_tokens) / (tp + td), 2
        ),
        "reps": reps,
        "bulk_prefill": bulk,
    }
    return tokens.to(torch.int32), record
