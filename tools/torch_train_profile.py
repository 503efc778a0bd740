#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time.

Builds the trainer of ``--config`` (default ``configs/gpt2_owt.py``:
GPT-2 124M, batch 32 x 1024, bf16 compute, flash attention, fused AdamW;
``configs/resnet50_imagenet.py`` is ResNet-50 at batch 256 x 224²) through
``cli.build_all`` at full width, warms it up, times steps that each end in
a device sync, then traces a window of steps with ``torch.profiler`` and
prints one JSON line: host wall time per step, device busy time per step
(the sum of device-side kernel, copy and memset times), the device idle
share under the profiler, device time per kernel group (the port's flash
and AdamW kernels, convolutions, matrix products, reductions, copies, the
rest), and the kernels with the most device time. Each step draws its batch
on the host and copies it over (``data.prefetch``), as ``cli train`` does,
so an input path slower than the step shows as idle device time. For an
MoE model (``configs/llama_moe.py``, ``configs/gpt2_moe.py``) it also times,
with CUDA events at the step's shapes, one routed layer's pieces (the
routing, the dispatch and combine einsums over the one-hots, the experts,
each forward and backward) and gives their share of the busy step. Needs an
NVIDIA GPU:

    python3 tools/torch_train_profile.py [--config PATH] [--steps 5]
        [--override a.b=v ...]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "gpt2_owt.py")
# Kernel-name fragments -> group; the first that matches wins.
GROUPS = (
    ("flash_fwd", "flash_fwd_kernel"), ("flash_dq", "flash_dq_kernel"),
    ("flash_dkv", "flash_dkv_kernel"), ("fused_adamw", "fused_adamw_kernel"),
    ("conv", "conv"), ("conv", "dgrad"), ("conv", "wgrad"),
    ("conv", "fprop"), ("conv", "cudnn"), ("matmul", "gemm"), ("matmul", "sm90_xmma"), ("matmul", "cutlass"),
    ("matmul", "nvjet"), ("copy", "Memcpy"), ("copy", "copy_kernel"),
    ("copy", "Memset"), ("reduce", "reduce_kernel"),
    ("pool", "pool"),
)


def group_of(name: str) -> str:
    for group, frag in GROUPS:
        if frag in name:
            return group
    return "other"


def _event_ms(torch, fn, iters=10):
    """Median ms of ``fn()`` over ``iters`` calls, each between CUDA
    events, after one warm call."""
    fn()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def moe_pieces(torch, trainer, cfg):
    """ms of one routed layer's pieces at the step's shapes (this rank's
    rows, the compute dtype), forward and backward, and their sum over the
    model's routed layers; None for a model without experts."""
    import torch.nn.functional as F

    from distributeddeeplearning_tpu_torch.models.moe import moe_mlps
    from distributeddeeplearning_tpu_torch.parallel.ep import route_top_k

    mlps = moe_mlps(trainer.model)
    if not mlps:
        return None
    m, dt = mlps[0], trainer.precision.compute_dtype
    if not trainer.precision.mixed:
        dt = trainer.model.dtype
    B, L, d = cfg.data.batch_size, cfg.data.seq_len, m.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, L, d, device="cuda", generator=gen).to(dt)
    x.requires_grad_()
    w = {k: p.detach().to(dt).requires_grad_()
         for k, p in m.named_parameters() if k != "router.kernel"}
    router = m.router.kernel.detach().float()

    def route():
        probs = torch.softmax(x.detach().float().reshape(-1, d) @ router,
                              -1).reshape(B, L, -1)
        return route_top_k(probs, m.num_selected, m.capacity(L), dtype=dt)

    dispatch, combine, _, _ = route()
    combine.requires_grad_()
    expert_in = torch.einsum("gtec,gtd->egcd", dispatch, x)
    ein = expert_in.detach().requires_grad_()

    def experts(inp):
        if m.mlp_style == "swiglu":
            h = F.silu(torch.einsum("egcd,edh->egch", inp, w["w_gate"])) * (
                torch.einsum("egcd,edh->egch", inp, w["w1"]))
            return torch.einsum("egch,ehd->egcd", h, w["w2"])
        h = m.act(torch.einsum("egcd,edh->egch", inp, w["w1"])
                  + w["b1"][:, None, None, :])
        return (torch.einsum("egch,ehd->egcd", h, w["w2"])
                + w["b2"][:, None, None, :])

    out = experts(ein).detach().requires_grad_()
    g_in, g_out = torch.randn_like(expert_in), torch.randn_like(x)

    def dispatch_fb():
        y = torch.einsum("gtec,gtd->egcd", dispatch, x)
        torch.autograd.grad(y, x, g_in)

    def experts_fb():
        torch.autograd.grad(experts(ein), [ein, *w.values()], g_in)

    def combine_fb():
        y = torch.einsum("gtec,egcd->gtd", combine, out)
        torch.autograd.grad(y, [combine, out], g_out)

    layer = {"route_fwd": _event_ms(torch, route),
             "dispatch_fwd_bwd": _event_ms(torch, dispatch_fb),
             "experts_fwd_bwd": _event_ms(torch, experts_fb),
             "combine_fwd_bwd": _event_ms(torch, combine_fb)}
    n = len(mlps)
    return {"layers": n, "capacity": m.capacity(L),
            "layer_ms": layer,
            "step_ms": {k: v * n for k, v in layer.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from distributeddeeplearning_tpu_torch import cli, data
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    cfg = apply_overrides(load_config(args.config), args.override)
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    batches = data.prefetch(dataset.iter_from(0), "cuda")

    def step():
        nonlocal state
        state, metrics = trainer.train_step(state, next(batches))
        return metrics

    for _ in range(2):  # warm the libraries up
        step()
    torch.cuda.synchronize()
    step_s = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets): the aten ops that
    # launch them carry the same device time again.
    kernels = {
        ev.key: (ev.self_device_time_total, ev.count)
        for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
    }
    n = args.steps
    busy_us = sum(us for us, _ in kernels.values())
    moe = moe_pieces(torch, trainer, cfg)
    if moe is not None:
        busy_ms = busy_us / n / 1e3
        moe["share_of_busy_step"] = {
            k: v / busy_ms for k, v in moe["step_ms"].items()}
        moe["onehot_share_of_busy_step"] = (
            moe["step_ms"]["dispatch_fwd_bwd"]
            + moe["step_ms"]["combine_fwd_bwd"]) / busy_ms
    groups: dict[str, float] = {}
    for name, (us, _) in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / n / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    images = cfg.train.task == "classification"
    items = cfg.data.batch_size * (1 if images else cfg.data.seq_len)
    unit = "images" if images else "tokens"
    print(json.dumps({
        "config": os.path.basename(args.config), "overrides": args.override,
        "steps": n, f"{unit}_per_step": items,
        "p50_step_ms_unprofiled": statistics.median(step_s) * 1e3,
        f"{unit}_per_s_unprofiled": items / statistics.mean(step_s),
        "host_ms_per_step": wall / n * 1e3,
        "device_busy_ms_per_step": busy_us / n / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
        "device_ops_per_step": sum(c for _, c in kernels.values()) / n,
        "group_ms_per_step": dict(sorted(groups.items(),
                                         key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [
            [name[:90], us / n / 1e3, count / n]
            for name, (us, count) in top
        ],
        **({"moe_pieces": moe} if moe is not None else {}),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
