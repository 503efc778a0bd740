#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving engine spends its time.

Serves ``--config``'s model (default ``configs/gpt2_owt.py``: GPT-2 124M,
vocab 50257; ``configs/llama_lm.py`` is Llama-300M, vocab 32000) through
``distributeddeeplearning_tpu_torch``'s ``ServingEngine`` with 8 busy
lanes, then traces a window of decode steps with
``torch.profiler`` and prints one JSON line per configuration: host wall time
per step (p50 without the profiler, mean under it), device busy time per step (the
sum of device-side kernel, copy and memset times), the device idle share
under the profiler, the paged decode kernels' device time per step and their
share of the busy time, and the kernels with the most device time. Needs an
NVIDIA GPU:

    python3 tools/torch_decode_profile.py [--config PATH] [--steps 20]
        [--dtype bfloat16 ...]
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


def profile(torch, cfg, dtype, kernel, kv_quant, steps):
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.config import ServingConfig
    from distributeddeeplearning_tpu_torch.serving import (
        Request,
        ServingEngine,
    )

    model = models.get_model(cfg.model.name, **{**cfg.model.kwargs,
                                                "dtype": dtype})
    model.init_weights(torch.Generator().manual_seed(0))
    eng = ServingEngine(
        model.to("cuda"),
        ServingConfig(slots=8, block_size=16, max_seq_len=1024,
                      prompt_buckets=(128, 512), hbm_budget_mb=2048,
                      attn_kernel=kernel, kv_quant=kv_quant),
        device="cuda",
    )
    eng.warmup()
    rng = np.random.default_rng(0)
    for n in rng.integers(256, 501, 8):
        prompt = list(map(int, rng.integers(0, model.vocab_size, n)))
        eng.submit(Request(prompt=prompt, max_new_tokens=2 * steps + 10))
    for _ in range(5):  # admit all 8 and warm the decode path
        eng.step()
    torch.cuda.synchronize()
    step_s = []
    for _ in range(steps):  # the same window without the profiler
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies, memsets): the aten ops that
    # launch them carry the same device time again.
    kernels = {
        ev.key: (ev.self_device_time_total, ev.count)
        for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
    }
    busy_us = sum(us for us, _ in kernels.values())
    paged_us = sum(us for name, (us, _) in kernels.items() if "paged_" in name)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "dtype": dtype, "attn_kernel": kernel, "kv_quant": kv_quant,
        "steps": steps,
        "p50_step_ms_unprofiled": statistics.median(step_s) * 1e3,
        "host_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
        "device_ops_per_step": sum(c for _, c in kernels.values()) / steps,
        "paged_kernels_ms_per_step": paged_us / steps / 1e3,
        "paged_kernels_share_of_busy": paged_us / busy_us if busy_us else 0.0,
        "top_kernels_ms_per_step": [
            [name[:80], us / steps / 1e3, count / steps]
            for name, (us, count) in top
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--rounds", type=int, default=2,
                    help="repeat the configurations in turn this many times")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    cfg = apply_overrides(load_config(args.config),
                          ["model.kwargs.attn_impl=xla"])
    for rnd in range(args.rounds):
        for dtype in args.dtype:
            for kernel, kv_quant in (("pallas", "off"), ("reference", "off"),
                                     ("pallas", "int8")):
                rec = profile(torch, cfg, dtype, kernel, kv_quant, args.steps)
                print(json.dumps({"round": rnd, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
