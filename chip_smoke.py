#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # device, build, kernels vs plain only
                                     # (phases 1-3, 6 and 9; no result line)

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA sources of the port, compiled from this checkout;
     ptxas's registers and spills, and the tensor-core (HMMA) instruction
     count of each flash and ring kernel's machine code; the bf16 flash
     fwd/dq/dkv and ring_step/ring_dq/ring_dkv kernels must spill nothing
     and hold HMMA, the fp32 kernels of the two libraries must hold none;
     every paged decode instantiation (split and merge kernels, each q
     type, pool type and head dim) must spill nothing;
  3. kernels vs plain: each paged kernel's wrapper against its plain torch
     version at GPT-2 124M decode shapes (five cases), then their times,
     the bound of the same work on the card, and a library yardstick; then
     wide cases per kernel (64 rows, every cursor at 1023, every split
     live; bf16 q, which shows whether the kernel streams at HBM rate, and
     an fp32-q twin held to 2e-5), timed the same way;
  4. serve through the entry point: ``cli serve`` in-process on
     ``configs/gpt2_owt.py`` at 124M width (byte tokenizer), with the fp and
     the int8 KV pool; the launch counts must equal decode calls x layers;
  5. serve at full width: the engine on GPT-2 124M (vocab 50257, bf16),
     decode tokens/s and p50 decode-step time with each pool, then an fp32
     pair, kernel against gather, that must agree token for token;
  6. training kernels vs plain: flash fwd / dq / dkv and fused AdamW against
     their plain torch versions at GPT-2 124M training shapes (bf16 causal
     [384, 1024, 64]), the bf16 kernels' other mask paths (per-row limits,
     a pad limit at D = 128, causal L = 1000) and fp32 cases, then their
     times, bounds and library yardsticks;
  7. train through the entry point: ``cli train`` in-process on
     ``configs/gpt2_owt.py`` at full width (batch 32 x 1024, bf16, flash,
     adamw_fused) for 8 steps; launches must be 12 x steps per flash kernel
     and 2 x steps for fused_adamw, every loss finite;
  8. fp32 parity pair at 124M width: (flash, adamw_fused) through the
     kernels against (xla, adamw) through none, 4 steps on the same weights
     and batches; the losses must agree within 1e-4 relative and fall;
  9. ring kernels vs plain: ring_step / ring_dq / ring_dkv against their
     plain torch versions at the cp=2 training shapes ([384, 512, 64], bf16
     k/v, fp32 carries), mode 0 and 1, plus D=128 and L=200 cases in bf16
     and fp32, and four virtual cp ranks driven in lockstep against full
     causal attention, in fp32 and in bf16; every output's max abs error
     and share of its tolerance (bf16: ring_step and ring_dq 2e-3, which
     their two-term bf16 products hold, ring_dkv 2e-2); then the times,
     bounds and library yardsticks;
  10. context-parallel training through the entry point: ``cli train``
     under ``torchrun`` with 2 ranks, ``mesh.cp=2``, ``ring_pallas``, at
     full width for 6 steps. Both ranks share the one card over gloo, so
     the step times are no context-parallel speed. Launches must be 12 x
     steps per ring kernel on rank 0 and 24 x steps on rank 1, none of the
     flash kernels, 2 x steps of fused_adamw on each;
  11. fp32 parity at 124M width: 2 ranks at cp=2 (ring_pallas,
     adamw_fused) against phase 8's single-process flash route, 4 steps;
     the losses must agree within 1e-4 relative and fall;
  12. ZeRO-1 training through the entry point: ``cli train`` under
     ``torchrun`` with 2 ranks on ``configs/gpt2_owt.py`` as shipped
     (``zero1=True``, ``dp=-1`` -> 2, flash, adamw_fused, bf16, batch
     32 x 1024) with ``grad_accum=2``, evaluation and checkpoints every 2
     steps and the metrics writer, 4 steps: per rank, flash_dq and
     flash_dkv launch 12 x steps x grad_accum times, flash_fwd that many
     plus 12 x evaluations x eval_batches, fused_adamw 2 x steps; each
     rank's moments are half the unsharded bytes (plus padding);
     metrics.jsonl holds the train and eval lines; checkpoints exist at
     steps 2 and 4, and a second launch to 6 steps resumes from step 4;
     then 2 steps with ZeRO-1 off, for its memory. Both ranks share the
     one card over gloo, so the step times are no data-parallel speed;
  13. fp32 parity at 124M width: 2 ranks at dp=2 with ZeRO-1 and
     grad_accum=2 (flash, adamw_fused) against phase 8's single-process
     flash route, 4 steps: losses within 1e-4 relative and falling,
     params within ZERO_PARAM_LIMIT (clip and weight decay on); then, in
     fresh processes, 2 steps, a save, a resume and 2 more, equal to the
     straight run bit for bit.
  14. ResNet-50 training through the entry point: ``cli train`` in-process
     on ``configs/resnet50_imagenet.py`` as shipped (batch 256 x 224², bf16
     convs, SGD, label smoothing) for 8 steps, then 4 with the C++ loader
     (``data.kind=native_image``): images/s over steps 2..N, p50 step,
     peak memory, every loss finite; the path launches none of the nine
     hand kernels (its convs are cuDNN's, as the JAX package's are XLA's);
  15. ``cli benchmark`` on that config: the images/sec/chip record (p50,
     p90, MFU against the card's bf16 peak, peak memory), printed again
     on a line before the last;
  16. ResNet-50 at dp=2 under ``torchrun``, 2 ranks sharing the one card
     over gloo: fp32 (TF32 off) at a global batch of 16, grad_accum 1 and
     2, 4 steps against one process on the same batches (losses within
     1e-4 relative and falling, BatchNorm running statistics within
     ``BN_STATS_TOL``); then the shipped config with eval and
     checkpoints every 2 steps for 4 steps, and a launch in fresh
     processes resuming from step 2 that repeats steps 3 and 4 bit for
     bit. The step times are no data-parallel speed.
Phase 6 also holds fused AdamW over one ZeRO-1 rank's shard of the 124M
groups (dp=2, rank 1, starting inside the flat buffers) bit for bit.
Before the last line come the kernels record, the card's name and power
limit, and the benchmark record; the last line is
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
import re
import shutil
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
    "ring_step": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
    "ring_dq": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
    "ring_dkv": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
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
    "ring_step": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:56",
    "ring_dq": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:234",
    "ring_dkv": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:261",
}
TRAIN_STEPS = 8
# Instantiations in csrc/paged_attention.cu: the split kernel for 2 q types
# x 3 pool types x 3 head dims, the merge for 2 q types.
PAGED_SPLIT_KERNELS, PAGED_MERGE_KERNELS = 18, 2
# Symbol fragments of the bf16 instantiations on the tensor cores, per
# library (two head dims each, so six instantiations a library).
TC_KERNELS = {"flash_attention": ("flash_fwd_kernel_tc", "flash_dq_kernel_tc",
                                  "flash_dkv_kernel_tc"),
              "ring_attention": ("ring_step_kernel_tc", "ring_dq_kernel_tc",
                                 "ring_dkv_kernel_tc")}
CP_STEPS = 6


def phase(name):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def ptxas_stats(log):
    """{kernel symbol: (registers, spill bytes stored and loaded)} from
    nvcc's ``-Xptxas -v`` output, which names each kernel and then gives
    its spills and its registers."""
    stats = {}
    for entry in re.finditer(r"Compiling entry function '([^']+)'", log):
        tail = log[entry.end():]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", tail)
        used = re.search(r"Used (\d+) registers", tail)
        stats[entry[1]] = (int(used[1]), int(spill[1]) + int(spill[2]))
    return stats


def check_tensor_core_build(_build):
    """The bf16 tensor-core instantiations of the flash and ring libraries:
    ptxas must report no spills for them, and their machine code must hold
    tensor-core (HMMA) instructions (``cuobjdump -sass`` of the built
    library); every other kernel of the two (the fp32 instantiations) runs
    on the CUDA cores and must hold none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib_name, frags in TC_KERNELS.items():
        log = _build.BUILD_LOGS[lib_name]
        if log:  # "" when the library came from an earlier build
            tc = {sym: regs_spills
                  for sym, regs_spills in ptxas_stats(log).items()
                  if any(k in sym for k in frags)}
            print(f"  ptxas (registers, spill bytes) of the bf16 "
                  f"{lib_name} tensor-core kernels: {json.dumps(tc)}")
            if (len(tc) != 2 * len(frags)
                    or any(spill for _, spill in tc.values())):
                raise AssertionError(f"bf16 {lib_name} kernels spill: {tc}")
        lib = _build.build([lib_name])[lib_name]
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        hmma, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1].strip()
                hmma[fn] = 0
            elif fn is not None and "HMMA" in line:
                hmma[fn] += 1
        for fn, n in sorted(hmma.items()):
            print(f"  sass {lib_name} {fn}: {n} HMMA")
        tc = {fn: n for fn, n in hmma.items() if any(k in fn for k in frags)}
        if len(tc) != 2 * len(frags) or not all(tc.values()):
            raise AssertionError(f"bf16 {lib_name} kernels without HMMA: {tc}")
        other = {fn: n for fn, n in hmma.items() if fn not in tc and n}
        if other:
            raise AssertionError(f"CUDA-core {lib_name} kernels hold HMMA: "
                                 f"{other}")


def check_paged_build(_build):
    """Every instantiation of the paged decode library (the split kernel
    for each q type, pool type and head dim, the merge for each q type):
    ptxas must report no spills. Prints each one's registers."""
    log = _build.BUILD_LOGS["paged_attention"]
    if not log:  # "" when the library came from an earlier build
        return
    stats = {sym: regs_spills for sym, regs_spills in ptxas_stats(log).items()
             if "paged_" in sym}
    for sym, (regs, spill) in sorted(stats.items()):
        print(f"  ptxas paged_attention {sym}: {regs} registers, {spill} "
              "spill bytes")
    want = PAGED_SPLIT_KERNELS + PAGED_MERGE_KERNELS
    if len(stats) != want or any(spill for _, spill in stats.values()):
        raise AssertionError(f"paged decode kernels: {len(stats)} of {want} "
                             f"reported, or spilling: {stats}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------


def decode_case(torch, *, pool, q_dtype, num_rep, seed=0, wide=False):
    """GPT-2 124M decode shapes: B=8, H=12, D=64, bs=16, 64 pages per row,
    mixed cursors up to 1023, two idle rows on the null block, scattered
    block ids. ``pool`` is the pool's type, ``q_dtype`` the query's.
    ``wide``: 64 rows, every cursor at 1023 (a pool of 4,097 blocks)."""
    B, H, D, bs, pages = (64 if wide else 8), 12, 64, 16, 64
    kvh = H // num_rep
    lens = [1023] * B if wide else [0, 37, 255, 256, 511, 700, 0, 1023]
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
    (in decode, the 12 layers' pools do not fit the 50 MB L2 together).
    The card spins for ~0.5 ms after each flush, so that the host has
    enqueued the call before the start event: a call of a few microseconds
    is timed on the device, not at the host's enqueue rate."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
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
        # name: (pool type, q type, num_rep, atol, kernel, wide). bf16 and
        # int8_bf16q are the serving path's cases (bf16 compute); the fp32
        # cases hold the same kernels to a tight tolerance. The wide cases
        # read 64 rows x 1024 columns (~0.06 ms of HBM bytes in bf16), with
        # every split live: their outputs are ~0.01-0.05, so the bf16 ones
        # are held to 2e-3 (a few bf16 roundings of the largest output),
        # and an fp32-q twin of each holds the merge of all eight splits
        # to 2e-5.
        "bf16": (bf16, bf16, 1, 2e-2, "paged_decode", False),
        "fp32": (f32, f32, 1, 2e-5, "paged_decode", False),
        "gqa4_fp32": (f32, f32, 4, 2e-5, "paged_decode", False),
        "int8_bf16q": (i8, bf16, 1, 2e-2, "paged_decode_q8", False),
        "int8_fp32q": (i8, f32, 1, 2e-5, "paged_decode_q8", False),
        "bf16_wide": (bf16, bf16, 1, 2e-3, "paged_decode", True),
        "fp32_wide": (f32, f32, 1, 2e-5, "paged_decode", True),
        "int8_bf16q_wide": (i8, bf16, 1, 2e-3, "paged_decode_q8", True),
        "int8_fp32q_wide": (i8, f32, 1, 2e-5, "paged_decode_q8", True),
    }
    results = {}
    for name, (pool, qdt, rep, atol, kernel, wide) in cases.items():
        case = decode_case(torch, pool=pool, q_dtype=qdt, num_rep=rep,
                           wide=wide)
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


def check_adamw_shard(torch, models, fused, cfg):
    """One ZeRO-1 rank's update at GPT-2 124M over dp=2: rank 1's shard of
    each group's flat buffer (the decay and no-decay groups, 62.2M
    elements together), starting inside the buffer, one launch a group.
    Bit for bit against the plain version; then timed beside the bound
    (p, g, m, v read and p, m, v written: 28 B an element, over HBM) and
    the library's fused AdamW over the same two shards."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroLayout

    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    lay = ZeroLayout(dict(meta.named_parameters()), Mesh({"dp": 2}, 1))
    g = torch.Generator(device="cuda").manual_seed(5)

    def draw(n, scale):
        return torch.randn(n, generator=g, device="cuda") * scale

    wds = {"decay": cfg.optim.weight_decay, "no_decay": 0.0}
    shards = {}
    for grp, n in lay.padded.items():
        flat = draw(n, 0.02)
        sl = lay.shard_slice(grp)
        k = sl.stop - sl.start
        shards[grp] = dict(p=flat[sl], g=draw(k, 1e-3), m=draw(k, 1e-4),
                           v=draw(k, 1e-7).abs())
        if sl.start * 4 % 16 or sl.start == 0:
            raise AssertionError(f"shard of {grp} starts at {sl.start}")
    hp = dict(lr=6e-4, b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], 1000)
    ref = {grp: {k: t[k].clone() for k in "pgmv"}
           for grp, t in shards.items()}
    before = fused.LAUNCHES["fused_adamw"]

    def kernel():
        for grp, t in shards.items():
            fused.fused_adamw_group([t["p"]], [t["g"]], [t["m"]], [t["v"]],
                                    wd=wds[grp], c1=c1, c2=c2, **hp)

    def plain(sets=shards):
        for grp, t in sets.items():
            fused.fused_adamw_plain(t["p"], t["g"], t["m"], t["v"],
                                    wd=wds[grp], c1=c1, c2=c2, **hp)

    kernel()
    plain(ref)
    torch.cuda.synchronize()
    if fused.LAUNCHES["fused_adamw"] != before + len(shards):
        raise RuntimeError("fused_adamw shard: the wrapper did not launch")
    err = max((shards[grp][k] - ref[grp][k]).abs().max().item()
              for grp in shards for k in "pmv")
    if err != 0.0:
        raise AssertionError(f"fused_adamw shard disagrees with its plain "
                             f"version: max_abs_err {err}")
    params = []
    for grp, t in shards.items():
        q = torch.nn.Parameter(t["p"].clone())
        q.grad = t["g"].clone()
        params.append({"params": [q], "weight_decay": wds[grp]})
    opt = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], fused=True)
    elems = sum(t["p"].numel() for t in shards.values())
    nbytes = 28 * elems
    res = {"ms": time_ms(torch, kernel, iters=20),
           "plain_ms": time_ms(torch, plain, iters=5),
           "library_ms": time_ms(torch, opt.step, iters=20),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "elements": elems,
           "offsets": {grp: lay.shard_slice(grp).start for grp in shards},
           "launches_per_step": len(shards), "max_abs_err": err}
    print(f"  fused_adamw ZeRO-1 shard (dp=2, rank 1): {json.dumps(res)}",
          flush=True)
    return res


def check_training_kernels(torch, models, cfg):
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16: o, dq, dk, dv are rounded to bf16 (8 bits of mantissa) at the
    # output, so one rounding step apart is ~0.4% of the value, and the
    # tensor-core kernels round P and dS to bf16 inside the P V, dS K,
    # P^T dO and dS^T Q products (about 0.2% per term, averaging out over
    # the sum): 2e-2 absolute plus 2e-2 relative. fp32: only the order of the
    # fp32 sums differs (tiles vs one einsum), ~1e-6 of the magnitudes.
    res = check_flash(torch, fa, "bf16 causal [384, 1024, 64]",
                      flash_case(torch, dtype=bf16, bh=384, L=1024, D=64,
                                 causal=True), 2e-2, timed=True)
    # The bf16 kernels' other mask paths: per-row limits, a static pad
    # limit at D = 128, and a length that is no multiple of either tile.
    check_flash(torch, fa, "bf16 ragged kv_valid_lens, non-causal "
                "[96, 512, 64]",
                flash_case(torch, dtype=bf16, bh=96, L=512, D=64,
                           causal=False, ragged=True), 2e-2, timed=False)
    check_flash(torch, fa, "bf16 L=197 padded to 256, non-causal, D=128",
                flash_case(torch, dtype=bf16, bh=24, L=256, D=128,
                           causal=False, limit=197), 2e-2, timed=False)
    check_flash(torch, fa, "bf16 causal L=1000 [48, 1000, 64]",
                flash_case(torch, dtype=bf16, bh=48, L=1000, D=64,
                           causal=True), 2e-2, timed=False)
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
    res["fused_adamw_shard"] = check_adamw_shard(torch, models, fused, cfg)
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
            "max_abs_param_diff": pdiff, "params_kernels": pa_,
            "overrides": base + routes["kernels"]}


# ---------------------------------------------------------------------------
# 9. ring kernels vs plain
# ---------------------------------------------------------------------------


def ring_case(torch, rp, *, dtype, bh, L, D, seed=11):
    """Inputs of one ring visit as rank 1 of cp=2 meets them: its queries
    q, a diagonal block (k1, v1) and the block of rank 0 (k0, v0), dO; the
    carries after the diagonal visit (plain versions), the lse and delta of
    the whole forward, and the dq, dk, dv carried into the mode-0 visit."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k0, v0, k1, v1, do = (
        torch.randn(bh, L, D, generator=g, device="cuda").to(dtype)
        for _ in range(6))
    scale = D ** -0.5
    qf = q.float() * scale
    zero = dict(m=torch.full((bh, L, 1), -1e30, device="cuda"),
                l=torch.zeros(bh, L, 1, device="cuda"),
                acc=torch.zeros(bh, L, D, device="cuda"))
    diag = rp.ring_step_plain(qf, k1, v1, zero["m"], zero["l"], zero["acc"], 1)
    m, l, acc = rp.ring_step_plain(qf, k0, v0, *diag, 0)
    lse = m + torch.log(l)
    out = (acc / l).to(dtype)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    zd = torch.zeros(bh, L, D, device="cuda")
    dq1 = rp.ring_dq_plain(q, k1, v1, do, lse, delta, zd, 1, scale)
    dk1, dv1 = rp.ring_dkv_plain(q, k1, v1, do, lse, delta, zd, zd, 1, scale)
    return dict(q=q, qf=qf, blocks={1: (k1, v1), 0: (k0, v0)},
                carries={1: (zero["m"], zero["l"], zero["acc"]), 0: diag},
                grads={1: (zd, zd, zd), 0: (dq1, dk1, dv1)},
                do=do, lse=lse, delta=delta, scale=scale)


def ring_calls(rp, case, mode, plain=False):
    """(name -> zero-argument call) of the three kernels (or their plain
    versions) on the case's mode-``mode`` visit."""
    k, v = case["blocks"][mode]
    dq, dk, dv = case["grads"][mode]
    bwd = (case["q"], k, v, case["do"], case["lse"], case["delta"])
    sfx = "_plain" if plain else ""
    step, rdq, rdkv = (getattr(rp, n + sfx)
                       for n in ("ring_step", "ring_dq", "ring_dkv"))
    return {
        "ring_step": lambda: step(case["qf"], k, v, *case["carries"][mode],
                                  mode),
        "ring_dq": lambda: rdq(*bwd, dq, mode, case["scale"]),
        "ring_dkv": lambda: rdkv(*bwd, dk, dv, mode, case["scale"]),
    }


def ring_bounds(case, mode):
    """Least time of each ring kernel's work: its bytes (each input read
    once, each output written once) over HBM, and its matrix flops over the
    visible (row, column) pairs (mode 0: all L^2, mode 1: L(L+1)/2 per
    row block) over the bf16 tensor-core peak for bf16 k/v (fp32 CUDA-core
    peak for fp32):
      ring_step: S and PV, 4*D flops per pair; reads qf, k, v, m, l, acc
                 (fp32 but k, v), writes m, l, acc;
      ring_dq:   S, dP and dS K, 6*D per pair; reads q, k, v, dO, lse,
                 delta, dq, writes dq (fp32);
      ring_dkv:  S, dP, P^T dO and dS^T Q, 8*D per pair; reads q, k, v, dO,
                 lse, delta, dk, dv, writes dk, dv (fp32)."""
    bh, L, D = case["q"].shape
    el = case["q"].element_size()
    mat_t, mat_f, row = bh * L * D * el, bh * L * D * 4, bh * L * 4
    pairs = bh * L * L if mode == 0 else bh * L * (L + 1) // 2
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    work = {"ring_step": (mat_f + 2 * mat_t + 4 * row + 2 * mat_f,
                          4 * D * pairs),
            "ring_dq": (4 * mat_t + 2 * row + 2 * mat_f, 6 * D * pairs),
            "ring_dkv": (4 * mat_t + 2 * row + 4 * mat_f, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations", nbytes, flops)
    return out


RING_OUTPUTS = {"ring_step": ("m", "l", "acc"), "ring_dq": ("dq",),
                "ring_dkv": ("dk", "dv")}


def check_ring(torch, rp, name, case, atol, timed):
    """Each ring kernel against its plain version on the same inputs, in
    mode 1 (the diagonal visit) and mode 0 (a visible block); errors are
    held to atol + atol * |ref|, ``atol`` per kernel. Prints every output's
    max abs error and the largest share of its tolerance used."""
    res, errs = {}, {}
    for mode in (1, 0):
        kern, plain = ring_calls(rp, case, mode), ring_calls(rp, case, mode,
                                                             plain=True)
        for kname in kern:
            tol = atol[kname]
            before = rp.LAUNCHES[kname]
            got = kern[kname]()
            want = plain[kname]()
            torch.cuda.synchronize()
            if rp.LAUNCHES[kname] != before + 1:
                raise RuntimeError(f"ring {name}: {kname} did not launch")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = 0.0
            for out, a, b in zip(RING_OUTPUTS[kname], got, want):
                diff = (a - b).abs()
                e_out = diff.max().item()
                used = (diff / (tol + tol * b.abs())).max().item()
                errs[f"{kname} mode {mode} {out}"] = [e_out, used]
                e = max(e, e_out)
                if used > 1 or not torch.isfinite(a).all():
                    raise AssertionError(
                        f"ring {name}: {kname} mode {mode} {out} disagrees "
                        f"with its plain version: max_abs_err {e_out}, "
                        f"tolerance {tol} + {tol} * |ref|")
            res[(kname, mode)] = {"max_abs_err": e, "atol": tol}
    print(f"ring {name}: [max_abs_err, share of the tolerance used] "
          f"{json.dumps(errs)} (atol {json.dumps(atol)})", flush=True)
    if not timed:
        return res
    out = {}
    lib_fwd, lib_bwd = ring_yardsticks(torch, case)
    for mode in (1, 0):
        bounds = ring_bounds(case, mode)
        kern, plain = ring_calls(rp, case, mode), ring_calls(rp, case, mode,
                                                             plain=True)
        for kname in kern:
            r = dict(res[(kname, mode)])
            r["ms"] = time_ms(torch, kern[kname], iters=10)
            r["plain_ms"] = time_ms(torch, plain[kname], iters=3)
            r["bound_ms"], r["bound_by"], r["bytes"], r["flops"] = (
                bounds[kname])
            # The library's backward computes dq, dk and dv in one call: the
            # yardstick of the dq + dkv pair, recorded on both.
            r["library_ms"] = lib_fwd if kname == "ring_step" else lib_bwd
            print(f"  {kname} mode {mode}: {json.dumps(r)}", flush=True)
            if mode == 0:  # the full visible block: the kernels' record
                out[kname] = r
    return out


def ring_yardsticks(torch, case, heads=12):
    """Yardsticks only (the port never calls them): the library's
    ``scaled_dot_product_attention`` forward over one visible block (no
    mask) and its autograd backward, on the case's bf16 tensors viewed
    [B, H, L, D]."""
    F = torch.nn.functional
    bh, L, D = case["q"].shape
    k, v = case["blocks"][0]
    shape = (bh // heads, heads, L, D)
    q, k, v = (x.reshape(shape).detach().requires_grad_()
               for x in (case["q"], k, v))
    do = case["do"].reshape(shape)
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                  iters=10)
    o = F.scaled_dot_product_attention(q, k, v)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True), iters=10)
    return fwd, bwd


def composed_ring(torch, rp, fa, *, dtype, atol, cp=4, bh=48, L=512, D=64):
    """cp virtual ranks in lockstep in one process: the forward ring through
    ``ring_step``, then the backward ring through ``ring_dq``/``ring_dkv``,
    blocks rotating as Python lists (rank i receives from i + 1; dk, dv
    rotate with k, v and hop home at the end), as ``_ring_fwd`` and
    ``_ring_bwd`` drive them (qf = scale q in fp32, the output in q's type
    for delta). Outputs, lse, dq, dk, dv against full causal attention over
    the cp * L sequence through the flash module's plain versions, in fp32
    on the same (``dtype``) input values."""
    g = torch.Generator(device="cuda").manual_seed(21)
    full = [torch.randn(bh, cp * L, D, generator=g, device="cuda")
            .to(dtype).float() for _ in range(4)]
    q, k, v, do = ([x[:, i * L:(i + 1) * L].to(dtype).contiguous()
                    for i in range(cp)] for x in full)
    scale = D ** -0.5

    def rotate(xs):
        return xs[1:] + xs[:1]

    def visits():
        for t in range(cp):
            for i in range(cp):
                src = (i + t) % cp
                if src <= i:
                    yield t, i, int(src == i)

    carries = [(torch.full((bh, L, 1), -1e30, device="cuda"),
                torch.zeros(bh, L, 1, device="cuda"),
                torch.zeros(bh, L, D, device="cuda")) for _ in range(cp)]
    qf = [x.float() * scale for x in q]
    kt, vt = list(k), list(v)
    t_prev = 0
    for t, i, mode in visits():
        while t_prev < t:
            kt, vt, t_prev = rotate(kt), rotate(vt), t_prev + 1
        carries[i] = rp.ring_step(qf[i], kt[i], vt[i], *carries[i], mode)
    out = [acc / l for (_, l, acc) in carries]
    lse = [m + torch.log(l) for (m, l, _) in carries]
    delta = [(d.float() * o.to(dtype).float()).sum(-1, keepdim=True)
             for d, o in zip(do, out)]
    zeros = [torch.zeros(bh, L, D, device="cuda") for _ in range(cp)]
    dq, dk, dv = list(zeros), list(zeros), list(zeros)
    kt, vt = list(k), list(v)
    t_prev = 0
    for t, i, mode in visits():
        while t_prev < t:
            kt, vt, dk, dv = map(rotate, (kt, vt, dk, dv))
            t_prev += 1
        args = (q[i], kt[i], vt[i], do[i], lse[i], delta[i])
        dq[i] = rp.ring_dq(*args, dq[i], mode, scale)
        dk[i], dv[i] = rp.ring_dkv(*args, dk[i], dv[i], mode, scale)
    for _ in range(cp - t_prev):  # the last lap's remaining hops home
        dk, dv = rotate(dk), rotate(dv)
    torch.cuda.synchronize()
    kw = dict(causal=True, sm_scale=scale, limit=cp * L)
    o_ref, lse_ref = fa.flash_fwd_plain(*full[:3], **kw)
    dq_ref, delta_ref = fa.flash_dq_plain(*full[:3], o_ref, full[3], lse_ref,
                                          **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(*full[:3], full[3], lse_ref,
                                        delta_ref, **kw)
    errs = {}
    for name, got, want in (("out", out, o_ref), ("lse", lse, lse_ref[..., None]),
                            ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        a = torch.cat(got, dim=1)
        e = (a - want).abs().max().item()
        errs[name] = e
        if ((a - want).abs() > atol + atol * want.abs()).any():
            raise AssertionError(f"composed ring (cp={cp}, {dtype}): {name} "
                                 f"disagrees with full causal attention: "
                                 f"max_abs_err {e}, tolerance {atol} + "
                                 f"{atol} * |ref|")
    print(f"composed ring cp={cp} [{bh}, {cp} x {L}, {D}] "
          f"{str(dtype).replace('torch.', '')} vs full causal: "
          f"max_abs_err {json.dumps(errs)} (atol {atol})", flush=True)
    return errs


def check_ring_kernels(torch):
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas as rp

    bf16, f32 = torch.bfloat16, torch.float32
    # Every output is an fp32 carry. fp32: only the order of the fp32 sums
    # differs, 2e-5. The bf16 kernels run on the tensor cores, where the
    # bf16 inputs are exact. ring_dkv rounds P to bf16 inside P^T dO and dS
    # inside dS^T Q, ~0.2% per term as in the flash kernels: 2e-2 absolute
    # plus 2e-2 relative, their tolerance. ring_step takes P (and qf at
    # D = 128) as two bf16 terms and ring_dq takes dS as two, ~2^-16 left
    # of each, so the sums' order dominates again, over the carries'
    # larger magnitudes: 2e-3, the fp32 design's bf16 tolerance.
    bf16_tol = {"ring_step": 2e-3, "ring_dq": 2e-3, "ring_dkv": 2e-2}
    f32_tol = dict.fromkeys(bf16_tol, 2e-5)
    res = check_ring(torch, rp, "bf16 [384, 512, 64] (cp=2 training)",
                     ring_case(torch, rp, dtype=bf16, bh=384, L=512, D=64),
                     bf16_tol, timed=True)
    for dtype, tol in ((bf16, bf16_tol), (f32, f32_tol)):
        tname = str(dtype).replace("torch.", "")
        if dtype == f32:
            check_ring(torch, rp, "float32 [384, 512, 64]",
                       ring_case(torch, rp, dtype=f32, bh=384, L=512, D=64),
                       tol, timed=False)
        check_ring(torch, rp, f"{tname} D=128 [24, 256, 128]",
                   ring_case(torch, rp, dtype=dtype, bh=24, L=256, D=128),
                   tol, timed=False)
        check_ring(torch, rp, f"{tname} L=200, no multiple of 64 "
                   "[24, 200, 64]",
                   ring_case(torch, rp, dtype=dtype, bh=24, L=200, D=64),
                   tol, timed=False)
    composed_ring(torch, rp, fa, dtype=f32, atol=1e-4)
    # bf16: the tensor-core kernels' roundings, folded over every visit of
    # four ranks, against fp32 attention on the same bf16 values.
    composed_ring(torch, rp, fa, dtype=bf16, atol=2e-2)
    return res


# ---------------------------------------------------------------------------
# 10. / 11. context-parallel training
# ---------------------------------------------------------------------------


def cli_train_cp(torch, layers, steps=CP_STEPS):
    """``cli train`` under torchrun: 2 ranks, cp=2, ring_pallas, full width.
    Returns (rank 0's step seconds, the train_end record, the text)."""
    overrides = ["mesh.cp=2", "mesh.dp=1", "model.kwargs.attn_impl=ring_pallas",
                 f"train.steps={steps}", "train.log_every=1"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "distributeddeeplearning_tpu_torch.cli",
           "train", "--config", CONFIG, "--sync-steps"]
    for o in overrides:
        cmd += ["--override", o]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun cli train exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    lines = proc.stdout.strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in recs if "loss" in r]
    end = next(r for r in recs if r.get("event") == "train_end")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"cp cli train: losses {losses}")
    if len(end["ranks"]) != 2 or any(r["losses"] != losses
                                     for r in end["ranks"]):
        raise AssertionError(f"cp cli train: the ranks' losses differ "
                             f"{[r['losses'] for r in end['ranks']]}")
    want = [{"ring_step": layers * steps * (i + 1),
             "ring_dq": layers * steps * (i + 1),
             "ring_dkv": layers * steps * (i + 1),
             "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
             "fused_adamw": 2 * steps} for i in range(2)]
    got = [r["launches"] for r in end["ranks"]]
    print("\n".join(x for x in lines if not x.startswith("{")))
    print(f"losses {losses}")
    print(f"launches per rank {got} expected {want}", flush=True)
    if got != want:
        raise AssertionError(f"cp train launches {got} != {want}")
    return losses, end, got


def _rank_fit(rank, port, overrides, out_dir, ckpt_dir=None, stop=None,
              save_every=0, config=CONFIG):
    """One of 2 ranks (a child process): build_all + fit of ``config`` to
    ``stop`` (default ``train.steps``); with ``ckpt_dir``, restored from its
    latest step when it holds one and saved every ``save_every`` steps."""
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch import cli, data
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.mesh import (
        build_mesh,
        init_distributed,
        rank_device,
    )
    from distributeddeeplearning_tpu_torch.ops import fused_adamw
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas
    from distributeddeeplearning_tpu_torch.train import fit

    init_distributed("cuda")
    device = rank_device("cuda")
    cfg = apply_overrides(load_config(config), overrides)
    mesh = build_mesh(cfg.mesh)
    _, trainer, dataset = cli.build_all(cfg, device, mesh)
    state = trainer.init(cfg.train.seed)
    ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir)
    if ckpt is not None and ckpt.latest_step() is not None:
        state, _ = ckpt.restore(state)
    state, hist = fit(trainer, state, data.prefetch(
        data.sharded_batches(dataset.iter_from(state.step), mesh,
                             cfg.train.grad_accum), device),
        steps=stop or cfg.train.steps, log_every=1, log_fn=lambda m: None,
        ckpt=ckpt, save_every=save_every)
    torch.cuda.synchronize()
    if ckpt is not None:
        ckpt.close()
    out = {"losses": [r["loss"] for r in hist],
           "launches": {**ring_attention_pallas.LAUNCHES,
                        **fused_adamw.LAUNCHES},
           "timings": [] if ckpt is None else ckpt.timings}
    if rank == 0:
        out["params"] = {k: p.detach().cpu() for k, p in state.params.items()}
        out["model_state"] = {k: b.detach().cpu()
                              for k, b in state.model_state.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(torch, overrides, out_dir, ckpt_dir=None, stop=None,
                save_every=0, config=CONFIG):
    """2 ranks of :func:`_rank_fit`, sharing the one card over gloo: each
    rank's results."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.empty_cache()
    torch.multiprocessing.spawn(
        _rank_fit,
        args=(port, overrides, out_dir, ckpt_dir, stop, save_every, config),
        nprocs=2, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(2)]


def cp_parity(torch, parity, steps=4):
    """fp32 at 124M width: 2 ranks at cp=2 (ring_pallas, adamw_fused)
    against phase 8's single-process flash route on the same weights and
    batches."""
    import tempfile

    overrides = parity["overrides"] + [
        "model.kwargs.attn_impl=ring_pallas", "mesh.cp=2", "mesh.dp=1"]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(torch, overrides, tmp)
    la, lb = ranks[0]["losses"], parity["losses_kernels"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    pb = parity["params_kernels"]
    pdiff = max((ranks[0]["params"][k] - pb[k].cpu()).abs().max().item()
                for k in pb)
    print(f"cp=2 fp32 parity: losses ring {la} flash {lb} max rel diff "
          f"{rel}; max abs param diff after {steps} steps {pdiff} "
          f"(information); launches per rank "
          f"{[r['launches'] for r in ranks]}", flush=True)
    if ranks[1]["losses"] != la:
        raise AssertionError("cp=2 fp32 parity: the ranks' losses differ")
    if not rel <= 1e-4:
        raise AssertionError(f"cp=2 fp32 parity: loss rel diff {rel} > 1e-4")
    if not la[-1] < la[0]:
        raise AssertionError(f"cp=2 fp32 parity: loss did not fall {la}")
    return {"losses_ring": la, "losses_flash": lb, "max_rel_diff": rel,
            "max_abs_param_diff": pdiff}


# ---------------------------------------------------------------------------
# 12. / 13. ZeRO-1 training
# ---------------------------------------------------------------------------

ZERO_STEPS, ZERO_ACCUM, EVAL_BATCHES = 4, 2, 2
# Phase 13's largest param difference from the one-rank route after 4
# steps (clip and weight decay on): 5.1e-5 on an H100, gated at about
# twice that.
ZERO_PARAM_LIMIT = 1e-4


def torchrun_train(overrides, timeout=600, config=CONFIG):
    """``cli train --sync-steps`` under torchrun with 2 ranks on ``config``
    (default ``configs/gpt2_owt.py``): (rank 0's text lines, its JSON
    records, the train_end record)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           "distributeddeeplearning_tpu_torch.cli", "train", "--config",
           config, "--sync-steps"]
    for o in overrides:
        cmd += ["--override", o]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun cli train exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    lines = proc.stdout.strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    end = next(r for r in recs if r.get("event") == "train_end")
    return [x for x in lines if not x.startswith("{")], recs, end


def zero1_expected(layers, steps, evals):
    """Each rank's launches over ``steps`` steps and ``evals`` passes."""
    train = layers * steps * ZERO_ACCUM
    return {"flash_fwd": train + layers * evals * EVAL_BATCHES,
            "flash_dq": train, "flash_dkv": train, "fused_adamw": 2 * steps,
            "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}


def cli_train_zero1(torch, layers, n_params):
    """``cli train`` under torchrun on gpt2_owt as shipped (zero1=True,
    dp=-1 -> 2, flash, adamw_fused, bf16, batch 32 x 1024) with
    grad_accum=2, evaluation and checkpoints every 2 steps and the metrics
    writer: 4 steps, then a second launch resumes to 6; then 2 steps with
    ZeRO-1 off for its memory. Returns the first launch's train_end record,
    each rank's launches over both launches, and the numbers to report."""
    import tempfile

    full_bytes = 8 * n_params  # two fp32 moments, unsharded
    with tempfile.TemporaryDirectory() as tmp:
        ck, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "logs")
        base = [f"train.grad_accum={ZERO_ACCUM}", "train.save_every=2",
                "train.eval_every=2", f"train.eval_batches={EVAL_BATCHES}",
                "train.log_every=1", f"train.checkpoint_dir={ck}",
                f"train.log_dir={logs}"]
        text, recs, end = torchrun_train(base + [f"train.steps={ZERO_STEPS}"])
        print("\n".join(text))
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["step"] for r in recs if "eval_loss" in r]
        if len(losses) != ZERO_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"zero1 cli train: losses {losses}")
        if evals != [2, 4]:
            raise AssertionError(f"zero1 cli train: eval records at {evals}")
        want = zero1_expected(layers, ZERO_STEPS, len(evals))
        got = [r["launches"] for r in end["ranks"]]
        print(f"losses {losses}\nlaunches per rank {got} expected {want}",
              flush=True)
        if got != [want, want]:
            raise AssertionError(f"zero1 train launches {got} != {want}")
        opt = [r["opt_state_bytes"] for r in end["ranks"]]
        # The padding: < dp x 4 = 8 elements in each of two groups, 8 bytes
        # of moments an element.
        if any(not 0 <= 2 * b - full_bytes < 2 * 8 * 8 for b in opt):
            raise AssertionError(f"zero1: per-rank optimizer bytes {opt} "
                                 f"are not half of {full_bytes}")
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            jl = [json.loads(x) for x in f]
        if ([r["step"] for r in jl if "loss" in r] != [1, 2, 3, 4]
                or [r["step"] for r in jl if "eval_loss" in r] != [2, 4]
                or any(r.get("schema") != 1 for r in jl)):
            raise AssertionError(f"metrics.jsonl: {jl}")
        steps_on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
        if steps_on_disk != [2, 4]:
            raise AssertionError(f"checkpoints at {steps_on_disk}")
        saves = end["ranks"][0]["checkpoints"]
        text2, recs2, end2 = torchrun_train(base + ["train.steps=6"])
        print("\n".join(text2))
        if "resumed from step 4" not in text2:
            raise AssertionError("the second launch did not resume from 4")
        steps2 = [r["step"] for r in recs2 if "loss" in r]
        want2 = zero1_expected(layers, 2, 1)
        got2 = [r["launches"] for r in end2["ranks"]]
        if steps2 != [5, 6] or got2 != [want2, want2]:
            raise AssertionError(f"resumed run: steps {steps2}, launches "
                                 f"{got2} != {want2}")
        _, _, off = torchrun_train([f"train.grad_accum={ZERO_ACCUM}",
                                    "train.zero1=false", "train.steps=2",
                                    "train.log_every=1"])
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    res = {
        "backend": end["backend"], "ranks_on_one_card": 2,
        "p50_step_ms": statistics.median(step_s) * 1e3,
        "step_ms": [x * 1e3 for x in step_s],
        "opt_state_bytes_per_rank": opt,
        "opt_state_bytes_zero1_off": [r["opt_state_bytes"]
                                      for r in off["ranks"]],
        "peak_mem_gb": [r["peak_mem_gb"] for r in end["ranks"]],
        "peak_mem_gb_zero1_off": [r["peak_mem_gb"] for r in off["ranks"]],
        "checkpoint_saves": saves,
    }
    print(f"zero1 train: {json.dumps(res)} (both ranks share the one card "
          "over gloo: not a data-parallel speed)", flush=True)
    launches = [{k: a[k] + b[k] for k in a} for a, b in zip(got, got2)]
    return res, launches


def zero1_parity(torch, parity, steps=4):
    """fp32 at 124M width: 2 ranks at dp=2 with ZeRO-1 and grad_accum=2
    (flash, adamw_fused) against phase 8's single-process flash route,
    then, in fresh processes, 2 steps, a save, a resume and 2 more, which
    must equal the straight run bit for bit."""
    import tempfile

    overrides = parity["overrides"] + [
        "mesh.dp=2", "train.zero1=true", f"train.grad_accum={ZERO_ACCUM}"]
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(torch, overrides, tmp)
        ck = os.path.join(tmp, "ckpt")
        first = spawn_ranks(torch, overrides, tmp, ck, stop=steps // 2,
                            save_every=steps // 2)
        second = spawn_ranks(torch, overrides, tmp, ck)
    la, lb = ranks[0]["losses"], parity["losses_kernels"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    pb = parity["params_kernels"]
    pdiff = max((ranks[0]["params"][k] - pb[k].cpu()).abs().max().item()
                for k in pb)
    resumed = [f["losses"] + s["losses"] for f, s in zip(first, second)]
    print(f"zero1 fp32 parity: losses dp=2 zero1 accum=2 {la} one rank {lb} "
          f"max rel diff {rel}; max abs param diff after {steps} steps "
          f"{pdiff} (limit {ZERO_PARAM_LIMIT}); saved and resumed {resumed}; "
          f"checkpoint "
          f"saves {first[0]['timings']}", flush=True)
    if ranks[1]["losses"] != la:
        raise AssertionError("zero1 fp32 parity: the ranks' losses differ")
    if not rel <= 1e-4:
        raise AssertionError(f"zero1 fp32 parity: loss rel diff {rel} > 1e-4")
    if not pdiff <= ZERO_PARAM_LIMIT:
        raise AssertionError(f"zero1 fp32 parity: param diff {pdiff} > "
                             f"{ZERO_PARAM_LIMIT}")
    if not la[-1] < la[0]:
        raise AssertionError(f"zero1 fp32 parity: loss did not fall {la}")
    if any(r != la for r in resumed):
        raise AssertionError(f"zero1 resume is not bit-exact: {resumed} "
                             f"against {la}")
    if any(not torch.equal(second[0]["params"][k], ranks[0]["params"][k])
           for k in pb):
        raise AssertionError("zero1 resume: params differ from the "
                             "straight run")
    return {"losses_zero1": la, "losses_one_rank": lb, "max_rel_diff": rel,
            "max_abs_param_diff": pdiff, "resumed_losses": resumed}


# ---------------------------------------------------------------------------
# 14. - 16. ResNet-50 data-parallel training (no hand kernel on the path)
# ---------------------------------------------------------------------------

RESNET = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "resnet50_imagenet.py")
RESNET_STEPS, NATIVE_STEPS = 8, 4
# Phase 16's fp32 parity at a global batch of 16 (8 a rank), one batch
# repeated at a constant lr low enough that the loss falls smoothly in 4
# steps. The runs agree to ~4e-7 through step 3, and then rounding grows
# by x20-x200 a step: at lr 0.1 the loss overshoots by step 3 and step 4
# parts by 3.5e-3; at 0.01 by 8.4e-5 (H100 runs of this phase).
RESNET_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=16",
                 "data.n_distinct=1", "optim.schedule=constant",
                 "optim.warmup_steps=0", "optim.lr=0.002", "train.steps=4"]
# Phase 16's BatchNorm running statistics against one process after 4
# steps, each tensor's largest difference over its largest value: flax's
# E[x²] - E[x]² loses ~1e-7 of E[x²] to the order of the sums, which is
# much of a small variance's value.
BN_STATS_TOL = 1e-3


def all_launches():
    """Every hand kernel's launch count, by name."""
    from distributeddeeplearning_tpu_torch.ops import (
        flash_attention,
        fused_adamw,
        paged_attention,
        ring_attention_pallas,
    )

    return {**paged_attention.LAUNCHES, **flash_attention.LAUNCHES,
            **fused_adamw.LAUNCHES, **ring_attention_pallas.LAUNCHES}


def reset_all_launches():
    from distributeddeeplearning_tpu_torch.ops import (
        flash_attention,
        fused_adamw,
        paged_attention,
        ring_attention_pallas,
    )

    for mod in (paged_attention, flash_attention, fused_adamw,
                ring_attention_pallas):
        mod.reset_launches()


def resnet_cli_train(torch, cli, steps, overrides=()):
    """``cli train --sync-steps`` in-process on resnet50_imagenet.py as
    shipped (batch 256 x 224², bf16, SGD): (losses, step seconds after the
    first, train_end record, text lines)."""
    argv = ["train", "--config", RESNET, "--device", "cuda", "--sync-steps",
            "--override", f"train.steps={steps}",
            "--override", "train.log_every=1"]
    for o in overrides:
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"resnet cli train exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in recs if "loss" in r]
    end = next(r for r in recs if r.get("event") == "train_end")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"resnet cli train: losses {losses}")
    return losses, end["step_s"][1:], end, [
        x for x in lines if not x.startswith("{")]


def resnet_train(torch, cli, batch):
    """Phase 14: 8 steps of the shipped config, then 4 with the C++
    loader; no hand kernel launches on this path."""
    out = {}
    for kind, steps, extra in (
            ("synthetic_image", RESNET_STEPS, ()),
            ("native_image", NATIVE_STEPS, ("data.kind=native_image",))):
        reset_all_launches()  # this path's counts start here
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, end, text = resnet_cli_train(torch, cli, steps,
                                                     extra)
        launched = all_launches()
        print("\n".join(text))
        res = {"data": kind, "losses": losses,
               "images_per_s": batch / statistics.mean(step_s),
               "p50_step_ms": statistics.median(step_s) * 1e3,
               "step_ms": [x * 1e3 for x in step_s],
               "peak_mem_gb": end["peak_mem_gb"],
               "opt_state_bytes": end["opt_state_bytes"]}
        print(f"resnet50 train: {json.dumps(res)}", flush=True)
        if any(launched.values()):
            raise AssertionError(f"resnet path launched hand kernels "
                                 f"{launched}: it should run none")
        out[kind] = res
    print("launches on the resnet path: none of the nine (as expected)",
          flush=True)
    return out


def resnet_benchmark(cli):
    """Phase 15: ``cli benchmark`` on the shipped config; its record."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["benchmark", "--config", RESNET, "--device", "cuda"])
    if rc != 0:
        raise RuntimeError(f"cli benchmark exited {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    for key in ("value", "p50_step_ms", "p90_step_ms", "mfu",
                "hbm_peak_bytes", "model_tflops_per_step"):
        if not isinstance(rec.get(key), (int, float)) or not rec[key] > 0:
            raise AssertionError(f"benchmark record: {key}={rec.get(key)!r}")
    if rec["platform"] != "gpu" or not math.isfinite(rec["loss"]):
        raise AssertionError(f"benchmark record: {rec}")
    return rec


def resnet_one_process(torch, cli, load_config, apply_overrides, accum):
    """Phase 16's reference: the parity config in this process."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.train import fit

    cfg = apply_overrides(load_config(RESNET), RESNET_PARITY + [
        f"train.grad_accum={accum}"])
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    state, hist = fit(trainer, state, data.prefetch(data.sharded_batches(
        dataset.iter_from(0), None, accum), "cuda"),
        steps=cfg.train.steps, log_every=1, log_fn=lambda m: None)
    torch.cuda.synchronize()
    out = ([r["loss"] for r in hist],
           {k: b.detach().cpu() for k, b in state.model_state.items()})
    del trainer, state
    torch.cuda.empty_cache()
    return out


def resnet_dp2(torch, cli, load_config, apply_overrides):
    """Phase 16: fp32 parity of dp=2 (grad_accum 1 and 2) against one
    process, then the shipped config under torchrun at dp=2 with eval and
    checkpoints every 2 steps, and a resume in fresh processes that
    repeats steps 3 and 4 bit for bit."""
    import tempfile

    parity = {}
    for accum in (1, 2):
        la, sa = resnet_one_process(torch, cli, load_config,
                                    apply_overrides, accum)
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_ranks(torch, RESNET_PARITY + [
                "mesh.dp=2", f"train.grad_accum={accum}"], tmp,
                config=RESNET)
        lb, sb = ranks[0]["losses"], ranks[0]["model_state"]
        rels = [abs(a - b) / abs(b) for a, b in zip(lb, la)]
        rel = max(rels)
        sdiff = max(((sb[k] - sa[k]).abs().max()
                     / sa[k].abs().max()).item() for k in sa)
        print(f"resnet50 fp32 dp=2 grad_accum={accum}: losses {lb} one "
              f"process {la} rel diff by step {rels}; running statistics' "
              f"largest diff over the tensor's largest value {sdiff} "
              f"(limit {BN_STATS_TOL}); launches per rank "
              f"{[r['launches'] for r in ranks]}", flush=True)
        if ranks[1]["losses"] != lb:
            raise AssertionError("resnet dp=2: the ranks' losses differ")
        if not rel <= 1e-4:
            raise AssertionError(f"resnet dp=2: loss rel diff {rel} > 1e-4")
        if not (lb[-1] < lb[0] and la[-1] < la[0]):
            raise AssertionError(f"resnet dp=2: loss did not fall {lb} {la}")
        if not sdiff <= BN_STATS_TOL:
            raise AssertionError(f"resnet dp=2: running statistics off by "
                                 f"{sdiff}")
        if any(any(r["launches"].values()) for r in ranks):
            raise AssertionError("resnet dp=2 launched hand kernels")
        parity[accum] = {"losses_dp2": lb, "losses_one": la,
                         "max_rel_diff": rel, "bn_stats_diff": sdiff}

    with tempfile.TemporaryDirectory() as tmp:
        ck, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "logs")
        base = ["train.save_every=2", "train.eval_every=2",
                "train.eval_batches=1", "train.log_every=1",
                f"train.checkpoint_dir={ck}", f"train.log_dir={logs}"]
        text, recs, end = torchrun_train(base + ["train.steps=4"],
                                         config=RESNET, timeout=900)
        print("\n".join(text))
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["step"] for r in recs if "eval_loss" in r]
        if len(losses) != 4 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"resnet dp=2 cli train: losses {losses}")
        if evals != [2, 4] or end["backend"] != "gloo":
            raise AssertionError(f"resnet dp=2 cli train: evals {evals}, "
                                 f"backend {end['backend']}")
        if any(r["losses"] != losses for r in end["ranks"]):
            raise AssertionError("resnet dp=2 cli train: ranks differ")
        steps_on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
        if steps_on_disk != [2, 4]:
            raise AssertionError(f"checkpoints at {steps_on_disk}")
        shutil.rmtree(os.path.join(ck, "4"))  # resume from step 2
        text2, recs2, _ = torchrun_train(base + ["train.steps=4"],
                                         config=RESNET, timeout=900)
        print("\n".join(text2))
        resumed = [r["loss"] for r in recs2 if "loss" in r]
        if "resumed from step 2" not in text2 or resumed != losses[2:]:
            raise AssertionError(f"resnet resume: {resumed} against "
                                 f"{losses[2:]}")
    step_s = end["step_s"][1:]
    res = {"backend": end["backend"], "ranks_on_one_card": 2,
           "p50_step_ms": statistics.median(step_s) * 1e3,
           "step_ms": [x * 1e3 for x in step_s], "losses": losses,
           "resumed_losses": resumed,
           "peak_mem_gb": [r["peak_mem_gb"] for r in end["ranks"]],
           "checkpoint_saves": end["ranks"][0]["checkpoints"],
           "parity": parity}
    print(f"resnet50 dp=2 train: {json.dumps(res)} (both ranks share the one "
          "card over gloo: not a data-parallel speed)", flush=True)
    return res


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
    names = ["paged_attention", "flash_attention", "fused_adamw",
             "ring_attention"]
    _build.build(names)  # one nvcc per source, all started together
    print(f"build_s {time.perf_counter() - t0:.2f}")
    for name in names:
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    check_tensor_core_build(_build)
    check_paged_build(_build)

    phase("3 kernels vs plain")
    kres = check_kernels(torch, pa)

    cfg = load_config(CONFIG)
    if args.quick:
        phase("6 training kernels vs plain")
        check_training_kernels(torch, models, cfg)
        phase("9 ring kernels vs plain")
        check_ring_kernels(torch)
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
    parity = parity_pair(torch, cli, load_config, apply_overrides)

    phase("9 ring kernels vs plain")
    kres.update(check_ring_kernels(torch))

    phase("10 context-parallel train through the entry point (torchrun)")
    # The ranks are fresh processes: their counts start at 0 with the run.
    torch.cuda.empty_cache()
    _, end, per_rank = cli_train_cp(torch, layers)
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    print(f"cp train: {json.dumps({'backend': end['backend'], 'ranks_on_one_card': 2, 'tokens_per_s': tokens / statistics.mean(step_s), 'p50_step_ms': statistics.median(step_s) * 1e3, 'step_ms': [x * 1e3 for x in step_s], 'peak_mem_gb': [r['peak_mem_gb'] for r in end['ranks']]})}"
          " (both ranks share the one card over gloo: not a "
          "context-parallel speed)", flush=True)
    for k in ("ring_step", "ring_dq", "ring_dkv"):
        launches[k] = sum(r[k] for r in per_rank)

    launches["fused_adamw"] += sum(r["fused_adamw"] for r in per_rank)

    phase("11 fp32 parity at 124M width, cp=2 against one rank")
    cp_parity(torch, parity)

    phase("12 ZeRO-1 train through the entry point (torchrun, dp=2)")
    n_params = sum(p.numel() for p in models.get_model(
        cfg.model.name, **cfg.model.kwargs, device="meta").parameters())
    _, zero_launches = cli_train_zero1(torch, layers, n_params)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += sum(r[k] for r in zero_launches)

    phase("13 fp32 parity at 124M width, ZeRO-1 dp=2 against one rank")
    zero1_parity(torch, parity)

    phase("14 ResNet-50 train through the entry point")
    rcfg = load_config(RESNET)
    resnet_train(torch, cli, rcfg.data.batch_size)

    phase("15 cli benchmark on ResNet-50")
    bench = resnet_benchmark(cli)

    phase("16 ResNet-50 dp=2 (torchrun, 2 ranks on one card over gloo)")
    resnet_dp2(torch, cli, load_config, apply_overrides)

    # Each kernel's numbers come from its case at the main path's types.
    main_case = {"paged_decode": "bf16", "paged_decode_q8": "int8_bf16q",
                 "flash_fwd": "flash_fwd", "flash_dq": "flash_dq",
                 "flash_dkv": "flash_dkv", "fused_adamw": "fused_adamw",
                 "ring_step": "ring_step", "ring_dq": "ring_dq",
                 "ring_dkv": "ring_dkv"}
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
    print(smi)
    print(json.dumps({"benchmark": bench}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
