#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # device, build, kernels vs plain only
                                     # (phases 1-3 and 6; no result line)

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA sources of the port, compiled from this checkout;
  3. kernels vs plain: each kernel's wrapper against its plain torch
     version at GPT-2 124M decode shapes, then their times, the bound of
     the same work on the card, and a library yardstick;
  4. serve through the entry point: ``cli serve`` in-process on
     ``configs/gpt2_owt.py`` at 124M width (byte tokenizer), with the fp and
     the int8 KV pool; the launch counts must equal decode calls x layers;
  5. serve at full width: the engine on GPT-2 124M (vocab 50257, bf16),
     decode tokens/s and p50 decode-step time with each pool, then an fp32
     pair, kernel against gather, that must agree token for token;
  6. training kernels vs plain: flash fwd / dq / dkv and fused AdamW against
     their plain torch versions at GPT-2 124M training shapes, then their
     times, bounds and library yardsticks;
  7. train through the entry point: ``cli train`` in-process on
     ``configs/gpt2_owt.py`` at full width (batch 32 x 1024, bf16, flash,
     adamw_fused) for 8 steps; launches must be 12 x steps per flash kernel
     and 2 x steps for fused_adamw, every loss finite;
  8. fp32 parity pair at 124M width: (flash, adamw_fused) through the
     kernels against (xla, adamw) through none, 4 steps on the same weights
     and batches; the losses must agree within 1e-4 relative and fall.
The line before the last is the kernels record; the last line is
``{"ok": true, "device": {...}}``. No GPU means no result line and a
non-zero exit: nothing here falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "gpt2_owt.py")
SOURCES = {
    "paged_decode": "distributeddeeplearning_tpu_torch/csrc/paged_attention.cu",
    "paged_decode_q8":
        "distributeddeeplearning_tpu_torch/csrc/paged_attention.cu",
    "flash_fwd": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "flash_dq": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "flash_dkv": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "fused_adamw": "distributeddeeplearning_tpu_torch/csrc/fused_adamw.cu",
}
# gpt2_owt.py trains with flash attention; serving refuses it by name, so
# every serving phase runs the config's xla attention core.
OVERRIDES = ["model.kwargs.attn_impl=xla"]
REPLACES = {
    "paged_decode": "distributeddeeplearning_tpu/ops/paged_attention.py:71",
    "paged_decode_q8": "distributeddeeplearning_tpu/ops/paged_attention.py:118",
    "flash_fwd": "distributeddeeplearning_tpu/ops/flash_attention.py:69",
    "flash_dq": "distributeddeeplearning_tpu/ops/flash_attention.py:213",
    "flash_dkv": "distributeddeeplearning_tpu/ops/flash_attention.py:254",
    "fused_adamw": "distributeddeeplearning_tpu/ops/fused_adamw.py:59",
}
TRAIN_STEPS = 8


def phase(name):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------


def decode_case(torch, *, pool, q_dtype, num_rep, seed=0):
    """GPT-2 124M decode shapes: B=8, H=12, D=64, bs=16, 64 pages per row,
    mixed cursors up to 1023, two idle rows on the null block, scattered
    block ids. ``pool`` is the pool's type, ``q_dtype`` the query's."""
    B, H, D, bs, pages = 8, 12, 64, 16, 64
    kvh = H // num_rep
    lens = [0, 37, 255, 256, 511, 700, 0, 1023]
    nb = 1 + B * pages
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).to(q_dtype)
    shape = (nb, bs, kvh, D)
    sk = sv = None
    if pool == torch.int8:
        pk = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        sk = torch.rand(shape[:3], generator=g, device=dev) / 127
        sv = torch.rand(shape[:3], generator=g, device=dev) / 127
    else:
        pk = torch.randn(shape, generator=g, device=dev).to(pool)
        pv = torch.randn(shape, generator=g, device=dev).to(pool)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    table = torch.zeros(B, pages, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        if n:
            need = n // bs + 1
            table[b, :need] = perm[used:used + need].to(torch.int32)
            used += need
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return dict(q=q, pool_k=pk, pool_v=pv, page_table=table,
                seq_lens=seq_lens, scale_k=sk, scale_v=sv, num_rep=num_rep)


def bound(case):
    """Least time of the work on the card: the bytes this call must move
    (the visible pool columns and their scales, q, the output, the touched
    table entries and the cursors, each once) over HBM, and its flops (QK
    and PV, 4 per visible element per head) over the fp32 peak."""
    lens = case["seq_lens"].tolist()
    B, H, D = case["q"].shape
    _, bs, kvh, _ = case["pool_k"].shape
    cols = sum(n + 1 for n in lens)
    nbytes = cols * kvh * D * 2 * case["pool_k"].element_size()
    if case["scale_k"] is not None:
        nbytes += cols * kvh * 2 * 4
    nbytes += 2 * case["q"].numel() * case["q"].element_size()
    nbytes += sum(n // bs + 1 for n in lens) * 4 + B * 4
    flops = cols * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters=30):
    """Mean device time of ``fn`` per call, L2 flushed before each call
    (in decode, the 12 layers' pools do not fit the 50 MB L2 together)."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def library_call(torch, case):
    """Yardstick only (the port never calls it): gather the pages, then
    ``scaled_dot_product_attention`` under the cursor mask."""
    F = torch.nn.functional
    q, tbl = case["q"], case["page_table"].long()
    B, H, D = q.shape
    _, bs, kvh, _ = case["pool_k"].shape
    rep = case["num_rep"]

    def gathered(pool, scale):
        x = pool[tbl].reshape(B, -1, kvh, D)
        if scale is not None:
            x = x.to(q.dtype) * scale[tbl].reshape(B, -1, kvh, 1).to(q.dtype)
        x = x.transpose(1, 2)
        return x.repeat_interleave(rep, dim=1) if rep > 1 else x

    def fn():
        k = gathered(case["pool_k"], case["scale_k"])
        v = gathered(case["pool_v"], case["scale_v"])
        cols = torch.arange(k.shape[2], device=q.device)
        mask = (cols[None, :] <= case["seq_lens"].long()[:, None])[:, None, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask)[:, :, 0]
    return fn


def check_kernels(torch, pa):
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cases = {
        # name: (pool type, q type, num_rep, atol, kernel). bf16 and
        # int8_bf16q are the serving path's cases (bf16 compute); the fp32
        # cases hold the same kernels to a tight tolerance.
        "bf16": (bf16, bf16, 1, 2e-2, "paged_decode"),
        "fp32": (f32, f32, 1, 2e-5, "paged_decode"),
        "gqa4_fp32": (f32, f32, 4, 2e-5, "paged_decode"),
        "int8_bf16q": (i8, bf16, 1, 2e-2, "paged_decode_q8"),
        "int8_fp32q": (i8, f32, 1, 2e-5, "paged_decode_q8"),
    }
    results = {}
    for name, (pool, qdt, rep, atol, kernel) in cases.items():
        case = decode_case(torch, pool=pool, q_dtype=qdt, num_rep=rep)
        args = {k: v for k, v in case.items() if k != "num_rep"}
        before = pa.LAUNCHES[kernel]
        out = pa.paged_attention(**args, num_rep=rep)
        torch.cuda.synchronize()
        if pa.LAUNCHES[kernel] != before + 1:
            raise RuntimeError(f"{name}: wrapper did not launch {kernel}")
        ref = pa.paged_attention_plain(**args, num_rep=rep)
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= atol and torch.isfinite(out).all()):
            raise AssertionError(
                f"kernel {kernel} ({name}) disagrees with its plain version: "
                f"max_abs_err {err} > atol {atol}"
            )
        lib = library_call(torch, case)
        lib_err = (lib().float() - ref.float()).abs().max().item()
        res = {
            "kernel": kernel, "max_abs_err": err, "atol": atol,
            "ms": time_ms(torch, lambda: pa.paged_attention(**args,
                                                            num_rep=rep)),
            "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(
                **args, num_rep=rep)),
            "library_ms": time_ms(torch, lib),
            "library_max_abs_err": lib_err,
        }
        res["bound_ms"], res["bound_by"] = bound(case)
        results[name] = res
        print(f"{name}: {json.dumps(res)}", flush=True)
    return results


# ---------------------------------------------------------------------------
# 4. / 5. serving
# ---------------------------------------------------------------------------


def cli_serve(cli, kv_quant):
    prompts = ["The H100 decodes", "paged attention reads the pool in place",
               "hello", "continuous batching over four lanes",
               "GPT-2 124M"]
    argv = ["serve", "--config", CONFIG, "--device", "cuda"]
    for o in OVERRIDES + ["model.kwargs.vocab_size=256",
                          "serving.attn_kernel=pallas",
                          f"serving.kv_quant={kv_quant}"]:
        argv += ["--override", o]
    for p in prompts:
        argv += ["--prompt", p]
    argv += ["--max-new-tokens", "24"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli serve exited {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    res = rec["results"]
    if len(res) != len(prompts) or any(r["new_tokens"] != 24 for r in res):
        raise AssertionError(f"cli serve ({kv_quant}): incomplete {res}")
    print(f"cli serve kv_quant={kv_quant}: "
          f"{json.dumps([r['completion'] for r in res])} "
          f"decode calls {rec['stats']['calls']['decode']}", flush=True)
    return rec["stats"]["calls"]["decode"]


def make_engine_cls(ServingEngine):
    class GapEngine(ServingEngine):
        """Records each sampled token's top-2 logit gap per request, so a
        greedy mismatch can say how close the call was."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps, self._admitting = {}, None

        def _admit_one(self, state):
            self._admitting = state
            try:
                super()._admit_one(state)
            finally:
                self._admitting = None

        def _sample_body(self, logits, *a):
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            owners = ([self._admitting] if self._admitting is not None
                      else self.scheduler.slots)
            for st, gap in zip(owners, gaps):
                if st is not None:
                    self.gaps.setdefault(st.request.request_id, []).append(gap)
            return super()._sample_body(logits, *a)

    return GapEngine


def serve_full_width(torch, pa, cli, ServingEngine, ServingConfig, Request,
                     load_config, apply_overrides):
    import numpy as np

    from distributeddeeplearning_tpu_torch import models

    cfg = apply_overrides(load_config(CONFIG), OVERRIDES)
    model = cli.build_model(cfg, "cuda")  # 124M, vocab 50257, bf16
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 501, 16)
    prompts = [list(map(int, rng.integers(0, model.vocab_size, n)))
               for n in lens]
    Engine = make_engine_cls(ServingEngine)

    def serve(model, **kw):
        scfg = ServingConfig(slots=8, block_size=16, max_seq_len=1024,
                             prompt_buckets=(128, 512), hbm_budget_mb=2048,
                             **kw)
        eng = Engine(model, scfg, seed=0, device="cuda")
        eng.warmup()
        before = dict(pa.LAUNCHES)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = sum(pa.LAUNCHES.values()) - sum(before.values())
        want = (eng.calls["decode"] * model.num_layers
                if kw.get("attn_kernel") == "pallas" else 0)
        if launched != want:
            raise AssertionError(
                f"full width {kw}: {launched} kernel launches, expected "
                f"{want} (decode calls x layers)"
            )
        decode_tokens = sum(len(s.generated) - 1 for s in done)
        if len(done) != len(prompts) or any(
                len(s.generated) != 64 for s in done):
            raise AssertionError(f"full width {kw}: incomplete requests")
        stats = {
            **{k: v for k, v in kw.items()},
            "dtype": str(model.dtype).replace("torch.", ""),
            "requests": len(done),
            "decode_calls": eng.calls["decode"],
            "decode_tokens_per_s": decode_tokens / sum(eng.decode_step_s),
            "p50_decode_step_ms": statistics.median(eng.decode_step_s) * 1e3,
            "wall_s": wall,
            "num_blocks": eng.num_blocks,
        }
        print(f"full width: {json.dumps(stats)}", flush=True)
        return done, eng

    serve(model, attn_kernel="pallas", kv_quant="off")
    serve(model, attn_kernel="pallas", kv_quant="int8")
    model32 = models.get_model(cfg.model.name, **{
        **cfg.model.kwargs, "dtype": "float32"}).to("cuda")
    model32.load_state_dict(model.state_dict())
    del model
    a_done, a_eng = serve(model32, attn_kernel="pallas")
    b_done, b_eng = serve(model32, attn_kernel="reference")
    for a, b in zip(a_done, b_done):
        if a.generated != b.generated:
            rid = a.request.request_id
            t = next(i for i, (x, y) in enumerate(zip(a.generated,
                                                       b.generated)) if x != y)
            print(f"fp32 mismatch: request {rid} token {t}: kernel "
                  f"{a.generated[t]} vs gather {b.generated[t]}; top-2 "
                  f"logit gap {a_eng.gaps[rid][t]} (kernel) "
                  f"{b_eng.gaps[rid][t]} (gather)", flush=True)
            raise AssertionError("fp32 greedy tokens differ, kernel vs gather")
    print(f"fp32 kernel vs gather: {len(a_done)} requests x 64 greedy tokens "
          "identical", flush=True)


# ---------------------------------------------------------------------------
# 6. training kernels vs plain
# ---------------------------------------------------------------------------


def flash_case(torch, *, dtype, bh, L, D, causal, ragged=False, limit=None,
               heads=12, seed=1):
    """Folded [bh, L, D] inputs: q, k, v, dO standard normal; ``ragged``
    gives each batch row (``heads`` folded rows) a kv limit in [1, L];
    ``limit`` is the static true length of a padded sequence (rows and
    columns past it zero, as the wrapper pads)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = [torch.randn(bh, L, D, generator=g, device="cuda") for _ in range(4)]
    limit = L if limit is None else limit
    for x in t:
        x[:, limit:] = 0
    q, k, v, do = (x.to(dtype).contiguous() for x in t)
    vl = None
    if ragged:
        lens = torch.randint(1, L + 1, (bh // heads,), generator=g,
                             device="cuda", dtype=torch.int32)
        lens[0] = L
        vl = lens.repeat_interleave(heads).contiguous()
    return dict(q=q, k=k, v=v, do=do, vl=vl, causal=causal, limit=limit,
                sm_scale=1.0 / D ** 0.5)


def visible_pairs(torch, case):
    """(row, column) pairs of the case's visible tiles' work: what the
    kernels must compute, row by row."""
    bh, L, _ = case["q"].shape
    rows = torch.arange(L, device="cuda")
    lim = torch.full((bh,), min(case["limit"], L), device="cuda")
    if case["vl"] is not None:
        lim = torch.minimum(lim, case["vl"].long())
    per_row = lim[:, None].expand(bh, L)
    if case["causal"]:
        per_row = torch.minimum(per_row, rows[None, :] + 1)
    return int(per_row.sum().item())


def flash_bounds(torch, case):
    """Least time of each flash kernel's work on the card: its bytes (each
    input read once, each output written once) over HBM, and its matrix
    flops over the visible (row, column) pairs over the tensor-core bf16
    peak for bf16 inputs (the fp32 CUDA-core peak for fp32):
      fwd: S = QK^T and O = PV, 4*D flops per pair; reads q, k, v, writes
           o and lse;
      dq:  S, dP = dO V^T and dQ = dS K, 6*D per pair; reads q, k, v, o,
           dO, lse, writes dq and delta;
      dkv: S, dP, dV = P^T dO and dK = dS^T Q, 8*D per pair; reads q, k, v,
           dO, lse, delta, writes dk and dv."""
    bh, L, D = case["q"].shape
    el = case["q"].element_size()
    mat, row = bh * L * D * el, bh * L * 4
    pairs = visible_pairs(torch, case)
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    work = {"flash_fwd": (4 * mat + row, 4 * D * pairs),
            "flash_dq": (6 * mat + 2 * row, 6 * D * pairs),
            "flash_dkv": (6 * mat + 2 * row, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations",
                     nbytes, flops)
    return out


def check_flash(torch, fa, name, case, atol, timed):
    """Each flash kernel against its plain version on the same inputs
    (the backward kernels fed the plain forward's o and lse, and dkv the
    plain dq's delta, so each is held alone)."""
    kw = dict(causal=case["causal"], sm_scale=case["sm_scale"],
              limit=case["limit"], vl=case["vl"])
    q, k, v, do = case["q"], case["k"], case["v"], case["do"]
    L = case["limit"]

    def err(a, b, what):
        a, b = a[:, :L].float(), b[:, :L].float()
        e = (a - b).abs().max().item()
        bad = (a - b).abs() > atol + atol * b.abs()
        if bad.any() or not torch.isfinite(a).all():
            raise AssertionError(
                f"flash {name}: {what} disagrees with its plain version: "
                f"max_abs_err {e}, tolerance {atol} + {atol} * |ref|")
        return e

    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    dq, delta = fa.flash_dq(q, k, v, o_ref, do, lse_ref, **kw)
    dq_ref, delta_ref = fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta_ref, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta_ref, **kw)
    torch.cuda.synchronize()
    if any(fa.LAUNCHES[x] != before[x] + 1 for x in before):
        raise RuntimeError(f"flash {name}: a wrapper did not launch")
    errs = {
        "flash_fwd": max(err(o, o_ref, "o"),
                         err(lse[..., None], lse_ref[..., None], "lse")),
        "flash_dq": max(err(dq, dq_ref, "dq"),
                        err(delta[..., None], delta_ref[..., None], "delta")),
        "flash_dkv": max(err(dk, dk_ref, "dk"), err(dv, dv_ref, "dv")),
    }
    res = {k: {"max_abs_err": e, "atol": atol} for k, e in errs.items()}
    print(f"flash {name}: max_abs_err {json.dumps(errs)} (atol {atol})",
          flush=True)
    if not timed:
        return res
    bounds = flash_bounds(torch, case)
    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, o_ref, do, lse_ref, **kw),
                     lambda: fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref,
                                               **kw)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta_ref,
                                           **kw),
                      lambda: fa.flash_dkv_plain(q, k, v, do, lse_ref,
                                                 delta_ref, **kw)),
    }
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, case)
    for kname, (kern, plain) in times.items():
        r = res[kname]
        r["ms"] = time_ms(torch, kern, iters=10)
        r["plain_ms"] = time_ms(torch, plain, iters=3)
        r["bound_ms"], r["bound_by"], r["bytes"], r["flops"] = bounds[kname]
        # The library's backward computes dq, dk and dv in one call: it is
        # the yardstick of the dq + dkv pair, recorded on both.
        r["library_ms"] = lib_fwd if kname == "flash_fwd" else lib_bwd
        print(f"  {kname}: {json.dumps(r)}", flush=True)
    return res


def sdpa_yardsticks(torch, case, heads=12):
    """Yardsticks only (the port never calls them): the library's
    ``scaled_dot_product_attention(is_causal=True)`` forward, and its
    autograd backward, on the case's tensors viewed [B, H, L, D]."""
    F = torch.nn.functional
    bh, L, D = case["q"].shape
    shape = (bh // heads, heads, L, D)
    q, k, v = (case[x].reshape(shape).detach().requires_grad_()
               for x in ("q", "k", "v"))
    do = case["do"].reshape(shape)
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=case["causal"]), iters=10)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=case["causal"])
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True), iters=10)
    return fwd, bwd


def adamw_leaves(torch, models, cfg, fused):
    """GPT-2 124M's parameter shapes (the config's model on the meta
    device), split as the optimizer splits them: the kernel groups
    {(dtype, wd): [shapes]}."""
    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    params = dict(meta.named_parameters())
    _, groups = fused.split_leaves(params, cfg.optim.weight_decay)
    return {key: [tuple(params[n].shape) for n in names]
            for key, names in groups.items()}


def adamw_tensors(torch, shapes, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(scale, positive=False):
        out = []
        for shp in shapes:
            x = torch.randn(shp, generator=g, device="cuda") * scale
            out.append(x.abs() if positive else x)
        return out

    return dict(p=draw(0.02), g=draw(1e-3), m=draw(1e-4),
                v=draw(1e-7, positive=True))


def check_adamw(torch, fused, groups, cfg):
    """The kernel over each group against the plain version leaf by leaf,
    at step counts 1 and 1000 and weight decay 0.1 and 0: the design gives
    the plain version's numbers bit for bit, so the tolerance is 0."""
    hp = dict(b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    worst = 0.0
    (decayed, wd), shapes = next(
        (key, shp) for key, shp in groups.items() if key[1])
    for count in (1, 1000):
        c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], count)
        for wd_case in (wd, 0.0):
            t = adamw_tensors(torch, shapes, seed=count)
            ref = {k: [x.clone() for x in xs] for k, xs in t.items()}
            before = fused.LAUNCHES["fused_adamw"]
            fused.fused_adamw_group(t["p"], t["g"], t["m"], t["v"], lr=6e-4,
                                    wd=wd_case, c1=c1, c2=c2, **hp)
            for leaf in zip(ref["p"], ref["g"], ref["m"], ref["v"]):
                fused.fused_adamw_plain(*leaf, lr=6e-4, wd=wd_case, c1=c1,
                                        c2=c2, **hp)
            torch.cuda.synchronize()
            if fused.LAUNCHES["fused_adamw"] != before + 1:
                raise RuntimeError("fused_adamw: the wrapper did not launch")
            e = max((a - b).abs().max().item()
                    for k in ("p", "m", "v") for a, b in zip(t[k], ref[k]))
            print(f"fused_adamw count={count} wd={wd_case}: max_abs_err {e} "
                  f"over {len(shapes)} leaves", flush=True)
            if e != 0.0 or not all(torch.isfinite(x).all() for x in t["p"]):
                raise AssertionError(
                    f"fused_adamw (count={count}, wd={wd_case}) disagrees "
                    f"with its plain version: max_abs_err {e}")
            worst = max(worst, e)
    return worst


def time_adamw(torch, fused, groups, cfg):
    """One optimizer step's launches at GPT-2 124M (every kernel group),
    the plain version over the same leaves, and the library's fused AdamW
    step over the same tensors. Bound: p, g, m, v read and p, m, v written,
    28 B per element, over HBM."""
    hp = dict(lr=6e-4, b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], 1000)
    sets = [(wd, adamw_tensors(torch, shapes, seed=7))
            for (_, wd), shapes in groups.items()]

    def kernel():
        for wd, t in sets:
            fused.fused_adamw_group(t["p"], t["g"], t["m"], t["v"], wd=wd,
                                    c1=c1, c2=c2, **hp)

    def plain():
        for wd, t in sets:
            for leaf in zip(t["p"], t["g"], t["m"], t["v"]):
                fused.fused_adamw_plain(*leaf, wd=wd, c1=c1, c2=c2, **hp)

    params = [p for _, t in sets for p in t["p"]]
    for (_, t) in sets:
        for p, g in zip(t["p"], t["g"]):
            p.grad = g
    opt = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=0.1, fused=True)
    elems = sum(p.numel() for p in params)
    nbytes = 28 * elems
    res = {
        "ms": time_ms(torch, kernel, iters=20),
        "plain_ms": time_ms(torch, plain, iters=5),
        "library_ms": time_ms(torch, opt.step, iters=20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes, "elements": elems, "launches_per_step": len(sets),
    }
    print(f"  fused_adamw step: {json.dumps(res)}", flush=True)
    return res


def check_training_kernels(torch, models, cfg):
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16: o, dq, dk, dv are rounded to bf16 (8 bits of mantissa) at the
    # output, so one rounding step apart is ~0.4% of the value: 2e-2
    # absolute plus 2e-2 relative. fp32: only the order of the fp32 sums
    # differs (tiles vs one einsum), ~1e-6 of the magnitudes.
    res = check_flash(torch, fa, "bf16 causal [384, 1024, 64]",
                      flash_case(torch, dtype=bf16, bh=384, L=1024, D=64,
                                 causal=True), 2e-2, timed=True)
    check_flash(torch, fa, "fp32 causal [384, 1024, 64]",
                flash_case(torch, dtype=f32, bh=384, L=1024, D=64,
                           causal=True), 2e-5, timed=False)
    check_flash(torch, fa, "fp32 ragged kv_valid_lens, non-causal "
                "[96, 512, 64]",
                flash_case(torch, dtype=f32, bh=96, L=512, D=64,
                           causal=False, ragged=True), 2e-5, timed=False)
    check_flash(torch, fa, "fp32 L=197 padded to 256, non-causal, D=128",
                flash_case(torch, dtype=f32, bh=24, L=256, D=128,
                           causal=False, limit=197), 2e-5, timed=False)
    groups = adamw_leaves(torch, models, cfg, fused)
    err = check_adamw(torch, fused, groups, cfg)
    res["fused_adamw"] = {**time_adamw(torch, fused, groups, cfg),
                          "max_abs_err": err}
    return res


# ---------------------------------------------------------------------------
# 7. / 8. training
# ---------------------------------------------------------------------------


def cli_train(torch, cli, steps):
    argv = ["train", "--config", CONFIG, "--device", "cuda", "--sync-steps",
            "--override", f"train.steps={steps}",
            "--override", "train.log_every=1"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli train exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in recs if "loss" in r]
    end = next(r for r in recs if r.get("event") == "train_end")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"cli train: losses {losses}")
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    return losses, step_s, [x for x in lines if not x.startswith("{")]


def parity_pair(torch, cli, load_config, apply_overrides, steps=4):
    """fp32 at 124M width: (flash, adamw_fused) against (xla, adamw) from
    the same seed's weights on the same batches."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused
    from distributeddeeplearning_tpu_torch.train import fit

    base = ["model.kwargs.dtype=float32", "data.batch_size=4",
            "data.n_distinct=1", "optim.schedule=constant",
            "optim.warmup_steps=0", "optim.grad_clip=1.0",
            f"train.steps={steps}"]
    routes = {"kernels": ["model.kwargs.attn_impl=flash",
                          "optim.name=adamw_fused"],
              "plain": ["model.kwargs.attn_impl=xla", "optim.name=adamw"]}
    out = {}
    from distributeddeeplearning_tpu_torch import data

    for name, extra in routes.items():
        cfg = apply_overrides(load_config(CONFIG), base + extra)
        model, trainer, dataset = cli.build_all(cfg, "cuda")
        state = trainer.init(cfg.train.seed)
        before = sum(fa.LAUNCHES.values()) + fused.LAUNCHES["fused_adamw"]
        state, hist = fit(trainer, state,
                          data.prefetch(dataset.iter_from(0), "cuda"),
                          steps=steps, log_every=1, log_fn=lambda m: None)
        torch.cuda.synchronize()
        launched = (sum(fa.LAUNCHES.values()) + fused.LAUNCHES["fused_adamw"]
                    - before)
        if (launched > 0) != (name == "kernels"):
            raise AssertionError(f"parity route {name}: {launched} kernel "
                                 "launches")
        out[name] = ([r["loss"] for r in hist],
                     {k: p.detach().clone() for k, p in state.params.items()})
        del model, trainer, state
        torch.cuda.empty_cache()
    (la, pa_), (lb, pb) = out["kernels"], out["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    pdiff = max((pa_[k] - pb[k]).abs().max().item() for k in pa_)
    print(f"fp32 parity: losses kernels {la} plain {lb} max rel diff {rel}; "
          f"max abs param diff after {steps} steps {pdiff} (information)",
          flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"fp32 parity: loss rel diff {rel} > 1e-4")
    if not (la[-1] < la[0] and lb[-1] < lb[0]):
        raise AssertionError(f"fp32 parity: loss did not fall {la} {lb}")
    return {"losses_kernels": la, "losses_plain": lb, "max_rel_diff": rel,
            "max_abs_param_diff": pdiff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernels-vs-plain phase")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch import cli, models
    from distributeddeeplearning_tpu_torch.config import (
        ServingConfig,
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import paged_attention as pa
    from distributeddeeplearning_tpu_torch.serving import (
        Request,
        ServingEngine,
    )

    # fp32 matmuls in full fp32 (the parity phases compare at fp32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    names = ["paged_attention", "flash_attention", "fused_adamw"]
    _build.build(names)  # one nvcc per source, all started together
    print(f"build_s {time.perf_counter() - t0:.2f}")
    for name in names:
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    phase("3 kernels vs plain")
    kres = check_kernels(torch, pa)

    cfg = load_config(CONFIG)
    if args.quick:
        phase("6 training kernels vs plain")
        check_training_kernels(torch, models, cfg)
        return 0  # a build-and-check run prints no result line

    phase("4 serve through the entry point")
    scfg = apply_overrides(cfg, OVERRIDES)
    layers = models.get_model(scfg.model.name, **scfg.model.kwargs,
                              device="meta").num_layers
    pa.reset_launches()  # the main path's count starts here
    calls_off = cli_serve(cli, "off")
    calls_q8 = cli_serve(cli, "int8")
    launches = dict(pa.LAUNCHES)
    want = {"paged_decode": calls_off * layers,
            "paged_decode_q8": calls_q8 * layers}
    print(f"launches {launches} expected {want}", flush=True)
    if launches != want or not all(launches.values()):
        raise AssertionError(
            f"kernel launches {launches} != decode calls x {layers} layers "
            f"{want}"
        )

    phase("5 serve at full width")
    serve_full_width(torch, pa, cli, ServingEngine, ServingConfig,
                     Request, load_config, apply_overrides)

    phase("6 training kernels vs plain")
    kres.update(check_training_kernels(torch, models, cfg))

    phase("7 train through the entry point")
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    fa.reset_launches()  # the training path's counts start here
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, text = cli_train(torch, cli, TRAIN_STEPS)
    train_launches = {**fa.LAUNCHES, **fused.LAUNCHES}
    want = {**{k: layers * TRAIN_STEPS for k in fa.LAUNCHES},
            "fused_adamw": 2 * TRAIN_STEPS}
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print("\n".join(text))
    print(f"losses {losses}")
    print(f"launches {train_launches} expected {want}")
    print(f"train: {json.dumps({'tokens_per_s': tokens / statistics.mean(step_s), 'p50_step_ms': statistics.median(step_s) * 1e3, 'step_ms': [x * 1e3 for x in step_s], 'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9})}", flush=True)
    if train_launches != want:
        raise AssertionError(f"train launches {train_launches} != {want}")
    launches.update(train_launches)

    phase("8 fp32 parity pair at 124M width")
    parity_pair(torch, cli, load_config, apply_overrides)

    # Each kernel's numbers come from its case at the main path's types.
    main_case = {"paged_decode": "bf16", "paged_decode_q8": "int8_bf16q",
                 "flash_fwd": "flash_fwd", "flash_dq": "flash_dq",
                 "flash_dkv": "flash_dkv", "fused_adamw": "fused_adamw"}
    kernels = []
    for kernel, name in main_case.items():
        r = kres[name]
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches[kernel],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
