#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time.

Builds the trainer of ``configs/gpt2_owt.py`` through ``cli.build_all`` at
full width (GPT-2 124M, batch 32 x 1024, bf16 compute, flash attention,
fused AdamW), warms it up, times steps that each end in a device sync, then
traces a window of steps with ``torch.profiler`` and prints one JSON line:
host wall time per step, device busy time per step (the sum of device-side
kernel, copy and memset times), the device idle share under the profiler,
device time per kernel group (the port's flash and AdamW kernels, matrix
products, the rest), and the kernels with the most device time. Needs an
NVIDIA GPU:

    python3 tools/torch_train_profile.py [--steps 5] [--override a.b=v ...]
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
    ("matmul", "gemm"), ("matmul", "sm90_xmma"), ("matmul", "cutlass"),
    ("matmul", "nvjet"), ("copy", "Memcpy"), ("copy", "copy_kernel"),
    ("copy", "Memset"),
)


def group_of(name: str) -> str:
    for group, frag in GROUPS:
        if frag in name:
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    cfg = apply_overrides(load_config(CONFIG), args.override)
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
    groups: dict[str, float] = {}
    for name, (us, _) in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / n / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print(json.dumps({
        "config": "gpt2_owt", "overrides": args.override, "steps": n,
        "tokens_per_step": tokens,
        "p50_step_ms_unprofiled": statistics.median(step_s) * 1e3,
        "tokens_per_s_unprofiled": tokens / statistics.mean(step_s),
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
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
