#!/usr/bin/env python3
"""Where a context-parallel training step of the PyTorch port spends its
time.

Starts ``--ranks`` processes (as ``torchrun`` would, on this host), each a
rank of ``configs/gpt2_owt.py`` at full width (GPT-2 124M, batch 32 x 1024,
bf16 compute) with ``mesh.cp=--cp``, ``mesh.dp=ranks/cp`` and
``attn_impl=ring_pallas``. Each rank warms up, times steps that end in a
device sync, then traces a window of steps with ``torch.profiler``. Rank 0
prints one JSON line: the backend, GPUs and ranks per GPU, p50 step time and
tokens/s, and per rank its device busy time per step, device idle share,
device time per kernel group (the ring kernels, matrix products, copies,
NCCL's collectives, the rest) and its top kernels, and the host time per
step inside the transport's calls (``DistComm.shift``, ``all_reduce_sum``,
and ZeRO-1's ``reduce_scatter_sum`` and ``all_gather``, timed by wrapping
them here). ``mesh.dp > 1`` runs ZeRO-1 off unless ``--override
train.zero1=true``. Ranks share the GPUs round-robin when
there are fewer GPUs than ranks (gloo); with one GPU each they run NCCL.
``--ranks 1 --cp 1`` profiles the single-GPU flash route for comparison.
Needs an NVIDIA GPU:

    python3 tools/torch_cp_profile.py [--ranks 2] [--cp 2] [--steps 4]
        [--override train.zero1=true]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "gpt2_owt.py")
# Kernel-name fragments -> group; the first that matches wins.
GROUPS = (
    ("ring_step", "ring_step_kernel"), ("ring_dq", "ring_dq_kernel"),
    ("ring_dkv", "ring_dkv_kernel"), ("flash", "flash_"),
    ("fused_adamw", "fused_adamw_kernel"),
    ("nccl_reduce_scatter", "ReduceScatter"),
    ("nccl_all_gather", "AllGather"), ("nccl_all_reduce", "AllReduce"),
    ("nccl_sendrecv", "SendRecv"),
    ("matmul", "gemm"), ("matmul", "sm90_xmma"), ("matmul", "cutlass"),
    ("matmul", "nvjet"), ("copy", "Memcpy"), ("copy", "copy_kernel"),
    ("copy", "Memset"),
)
COMM_CALLS = ("shift", "all_reduce_sum", "reduce_scatter_sum", "all_gather")


def group_of(name: str) -> str:
    for group, frag in GROUPS:
        if frag in name:
            return group
    return "other"


def overrides_for(ranks: int, cp: int) -> list[str]:
    if cp == 1:
        return ["mesh.dp=1"] if ranks == 1 else [
            f"mesh.dp={ranks}", "train.zero1=false"]
    return [f"mesh.cp={cp}", f"mesh.dp={ranks // cp}", "train.zero1=false",
            "model.kwargs.attn_impl=ring_pallas"]


def time_comm(comm, totals: dict) -> None:
    """Wrap the transport's calls on this instance: their host seconds add
    up in ``totals``."""
    for name in COMM_CALLS:
        fn = getattr(comm, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                totals[_name] = totals.get(_name, 0.0) + (
                    time.perf_counter() - t0)

        setattr(comm, name, timed)


def rank_main(rank, ranks, port, cp, steps, extra, out_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(ranks),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(ranks),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if ranks > 1:
        torch.set_num_threads(1)  # as torchrun sets OMP_NUM_THREADS
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch import cli, data
    from distributeddeeplearning_tpu_torch.comms import psum
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.mesh import (
        build_mesh,
        init_distributed,
        rank_device,
    )

    joined = init_distributed("cuda")
    device = rank_device("cuda") if joined else torch.device("cuda")
    cfg = apply_overrides(load_config(CONFIG),
                          overrides_for(ranks, cp) + extra)
    mesh = build_mesh(cfg.mesh)
    comm_s: dict[str, float] = {}
    if mesh.comm is not None:
        time_comm(mesh.comm, comm_s)
    _, trainer, dataset = cli.build_all(cfg, device, mesh)
    state = trainer.init(cfg.train.seed)
    batches = data.prefetch(
        data.sharded_batches(dataset.iter_from(0), mesh), device)

    def step():
        nonlocal state
        state, metrics = trainer.train_step(state, next(batches))
        return metrics

    def sync():
        torch.cuda.synchronize(device)
        psum(torch.zeros((), device=device), mesh)  # every rank is here

    for _ in range(2):  # warm the libraries up
        step()
    sync()
    step_s, losses = [], []
    comm_s.clear()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()["loss"]))
        torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
    comm_ms = {k: v / steps * 1e3 for k, v in comm_s.items()}
    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = {ev.key: ev.self_device_time_total for ev in events
               if ev.device_type == DeviceType.CUDA}
    busy_us = sum(kernels.values())
    groups: dict[str, float] = {}
    for name, us in kernels.items():
        g = group_of(name)
        groups[g] = groups.get(g, 0.0) + us / steps / 1e3
    report = {
        "rank": rank, "device": str(device),
        "p50_step_ms_unprofiled": statistics.median(step_s) * 1e3,
        "step_ms_unprofiled": [x * 1e3 for x in step_s],
        "losses": losses,
        "host_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
        "group_ms_per_step": dict(sorted(groups.items(),
                                         key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": [
            [name[:80], us / steps / 1e3] for name, us in
            sorted(kernels.items(), key=lambda kv: -kv[1])[:8]],
        "comm_host_ms_per_step_unprofiled": comm_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "zero1": trainer.layout is not None,
    }
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    if joined:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--override", action="append", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_cp_profile: no CUDA device", file=sys.stderr)
        return 2
    if args.ranks % args.cp:
        raise SystemExit(f"--ranks {args.ranks} not divisible by --cp "
                         f"{args.cp}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch.mesh import pick_backend
    from distributeddeeplearning_tpu_torch.ops import _build

    _build.build(["ring_attention", "flash_attention", "fused_adamw"])
    gpus = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            rank_main, args=(args.ranks, port, args.cp, args.steps,
                             args.override, tmp),
            nprocs=args.ranks, join=True)
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(args.ranks)]
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )

    cfg = apply_overrides(load_config(CONFIG), args.override)
    tokens = cfg.data.batch_size * cfg.data.seq_len
    p50 = ranks[0]["p50_step_ms_unprofiled"]
    print(json.dumps({
        "config": "gpt2_owt", "ranks": args.ranks, "cp": args.cp,
        "dp": args.ranks // args.cp, "gpus": min(gpus, args.ranks),
        "backend": ("none" if args.ranks == 1 else
                    pick_backend("cuda", args.ranks, gpus)),
        "overrides": overrides_for(args.ranks, args.cp) + args.override,
        "steps": args.steps, "p50_step_ms_unprofiled": p50,
        "tokens_per_s_unprofiled": tokens / statistics.mean(
            ranks[0]["step_ms_unprofiled"]) * 1e3,
        "per_rank": ranks,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
