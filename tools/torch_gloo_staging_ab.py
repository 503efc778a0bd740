#!/usr/bin/env python3
"""What the gloo transport's host staging costs: four ranks sharing one GPU
over gloo (``comms.DistComm`` with ``stage_on_host``) run the same
collectives with their CUDA tensors staged through pageable host memory
(a ``tensor.to("cpu")`` a call) and through pinned host memory (what
``DistComm`` does), alternating, in one process group:

- 30 all-reduces of a [4 x 1024 x 768] fp32 activation (12.6 MB: a
  tensor-parallel GPT-2 block's sum at 4 x 1024);
- 2 all-reduces of a 124M-element fp32 gradient (496 MB);
- 2 reduce-scatters and all-gathers of the same (ZeRO-1 and FSDP's pair).

Rank 0 prints one JSON record, seconds by staging and round. With
``--jobs``, the same four ranks then run jobs of ``chip_smoke.py``'s phase
34 group (phase 36's ``cli train`` at tp2 x fsdp2 with sequence
parallelism and phase 38's four expert-parallel jobs) under each staging,
in fresh processes each time, pageable, pinned, pinned, pageable; each
run prints one JSON record of rank 0's seconds by job and each job's step
seconds. Needs an NVIDIA GPU:

    python3 tools/torch_gloo_staging_ab.py [--rounds 2] [--jobs]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _pageable_out(self, t):
    if self.stage_on_host and t.device.type == "cuda":
        return t.to("cpu")
    return t.contiguous()


def _pageable_buffer(self, t, shape=None):
    import torch

    shape = t.shape if shape is None else shape
    if self.stage_on_host and t.device.type == "cuda":
        return torch.empty(shape, dtype=t.dtype, pin_memory=True)
    return torch.empty(shape, dtype=t.dtype, device=t.device)


def _rank(rank, port, rounds, out):
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="4", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from distributeddeeplearning_tpu_torch.comms import DistComm
    from distributeddeeplearning_tpu_torch.config import MeshConfig
    from distributeddeeplearning_tpu_torch.mesh import (
        build_mesh,
        init_distributed,
        rank_device,
    )

    device = rank_device("cuda")
    torch.cuda.set_device(device)
    init_distributed("cuda")
    comm = build_mesh(MeshConfig(dp=4)).comm
    stagings = {"pageable": (_pageable_out, _pageable_buffer),
                "pinned": (DistComm._out, DistComm._buffer)}
    small = torch.randn(4 * 1024 * 768, device=device)
    big = torch.randn(124_000_000, device=device)

    def timed(fn, n):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        return time.perf_counter() - t0

    def rs_ag():
        comm.all_gather(comm.reduce_scatter_sum(big, "dp"), "dp",
                        torch.empty_like(big))

    res = {}
    for _ in range(rounds):
        for name, (out_fn, buf_fn) in stagings.items():
            DistComm._out, DistComm._buffer = out_fn, buf_fn
            res.setdefault(name, []).append({
                "all_reduce_12.6MB_x30_s": timed(
                    lambda: comm.all_reduce_sum(small, "dp"), 30),
                "all_reduce_496MB_x2_s": timed(
                    lambda: comm.all_reduce_sum(big, "dp"), 2),
                "reduce_scatter_all_gather_496MB_x2_s": timed(rs_ag, 2),
            })
    DistComm._out, DistComm._buffer = stagings["pinned"]
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _staged_rank_fit(rank, staging, ports, jobs, out_dir, world):
    """``chip_smoke._rank_fit`` with the transport staged as ``staging``."""
    from distributeddeeplearning_tpu_torch.comms import DistComm

    if staging == "pageable":
        DistComm._out, DistComm._buffer = _pageable_out, _pageable_buffer
    import chip_smoke

    chip_smoke._rank_fit(rank, ports, jobs, out_dir, world)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for so in socks:
        so.bind(("localhost", 0))
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    return ports


def jobs_ab(torch) -> None:
    """Phase 36's and 38's jobs under each staging, ABBA."""
    import tempfile

    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import _build

    _build.build(["flash_attention", "fused_adamw", "ring_attention"])
    for staging in ("pageable", "pinned", "pinned", "pageable"):
        with tempfile.TemporaryDirectory() as tmp:
            jobs = [chip_smoke.tp_cli_job(tmp)[0],
                    *chip_smoke.ep_jobs(tmp)[0]]
            t0 = time.perf_counter()
            torch.multiprocessing.spawn(
                _staged_rank_fit,
                args=(staging, _free_ports(len(jobs)), jobs, tmp, 4),
                nprocs=4, join=True)
            wall = time.perf_counter() - t0
            res = [torch.load(os.path.join(tmp, f"rank0_job{j}.pt"))
                   for j in range(len(jobs))]
        print(json.dumps({
            "staging": staging, "spawn_s": wall,
            "job_s": [r["seconds"] for r in res],
            "step_s": [r.get("step_s") for r in res]}), flush=True)


def main(argv=None) -> int:
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--jobs", action="store_true",
                    help="then phase 36's and 38's jobs under each staging")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ab.json")
        torch.multiprocessing.spawn(_rank, args=(port, args.rounds, out),
                                    nprocs=4, join=True)
        with open(out) as f:
            print(json.dumps(json.load(f)), flush=True)
    if args.jobs:
        jobs_ab(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
