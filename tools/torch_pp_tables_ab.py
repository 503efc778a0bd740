#!/usr/bin/env python3
"""What storing a pipelined model's embedding table over (tp, pp) costs a
step: ``configs/gpt2_pp.py`` as shipped at pp2 x tp2 (``chip_smoke.py``
phase 39(a)'s job, the batch cut to 8 x 1024), run with the table stored
over (tp, pp) as the port stores it (the JAX package's ``vocab_pp``: each
pp rank holds a block of its tp slice and the ranks all-gather the slice
over pp a step) and with the table whole on every stage, alternating, in
one process group of 4 ranks sharing one GPU over gloo.

Each run prints one JSON record: the layout, every rank's step seconds,
the transport's seconds a step and the pipeline exchanges' seconds, the
param bytes a rank and the losses. Needs an NVIDIA GPU:

    python3 tools/torch_pp_tables_ab.py [--pairs 2] [--steps 4]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def rank(rank_id, ports, jobs, out_dir, world, whole):
    """One rank of :func:`chip_smoke._rank_fit`; with ``whole`` gpt2_pp
    keeps its table whole on every stage."""
    if whole:
        from distributeddeeplearning_tpu_torch.models import pipeline

        pipeline.PipelinedGPT2.VOCAB_PP = ()
    chip_smoke._rank_fit(rank_id, ports, jobs, out_dir, world)


def run(torch, whole: bool, steps: int) -> dict:
    jobs = [(chip_smoke.PP_TP_MESH + ["data.batch_size=8",
                                      f"train.steps={steps}"],
             None, 0, chip_smoke.GPT2_PP, {"params": False})]
    so = socket.socket()
    so.bind(("localhost", 0))
    ports = [so.getsockname()[1]]
    so.close()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(rank, args=(ports, jobs, tmp, 4, whole),
                                    nprocs=4, join=True)
        out = [torch.load(os.path.join(tmp, f"rank{r}_job0.pt"))
               for r in range(4)]
    return {"table": "whole over pp" if whole else "over (tp, pp)",
            "wall_s": time.perf_counter() - t0,
            "losses": out[0]["losses"],
            "step_s": [r["step_s"] for r in out],
            "transport_s_by_step": [r["transport_s_by_step"] for r in out],
            "pipeline_transport_s": [r["pipeline"]["train_transport_s"]
                                     for r in out],
            "param_bytes": [r["shards"]["param_bytes"] for r in out]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for i in range(args.pairs):
        order = (False, True) if i % 2 == 0 else (True, False)
        for whole in order:
            print(json.dumps(run(torch, whole, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
