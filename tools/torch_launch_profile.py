#!/usr/bin/env python3
"""Where the seconds of one ``torchrun … cli train`` launch of the PyTorch
port go: the agent's start, each worker's ``import torch``, its CUDA
context, ``build_all``, ``Trainer.init``, each step and the exit.

Builds the kernels first (as ``chip_smoke.py`` phase 2 does), times
``python -c "import torch"`` and a bare CUDA context in fresh processes,
then launches ``cli train --sync-steps`` under ``torchrun`` with 2 ranks
(``--nproc``) on ``--config`` (default ``configs/gpt2_owt.py`` as shipped)
with ``--override`` settings (default: ZeRO-1 off, grad_accum 2, 2 steps,
the ZeRO-1-off run of ``chip_smoke.py`` phase 13's pair). Each worker prints
the seconds since the launch began at each stage; the ``train_end``
record gives every step's seconds. Needs an NVIDIA GPU:

    python3 tools/torch_launch_profile.py [--config PATH] [--nproc 2]
        [--override train.steps=2 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OVERRIDES = ["train.zero1=false", "train.grad_accum=2",
                     "train.steps=2", "train.log_every=1"]


def worker(argv) -> int:
    """One rank: stamps each stage with the seconds since the launch."""
    t0 = float(os.environ["LAUNCH_PROFILE_T0"])
    rank = os.environ.get("RANK", "0")

    def stamp(what):
        print(f"rank{rank} {what}: {time.time() - t0:.2f} s", flush=True)

    stamp("python up")
    import torch

    stamp("import torch")
    torch.zeros(1, device="cuda")
    stamp("cuda context")
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch import cli, train

    stamp("import cli")

    def timed(owner, name):
        inner = getattr(owner, name)

        def call(*a, **k):
            stamp(f"{name} start")
            out = inner(*a, **k)
            stamp(f"{name} end")
            return out

        setattr(owner, name, call)

    timed(cli, "build_all")
    timed(train.Trainer, "init")
    rc = cli.main(argv)
    stamp(f"cli.main returned {rc}")
    return rc


def main() -> int:
    if os.environ.get("LAUNCH_PROFILE_T0"):
        return worker(sys.argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(
        ROOT, "distributeddeeplearning_tpu_torch", "configs",
        "gpt2_owt.py"))
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--override", action="append", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_launch_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch.ops import _build

    t = time.perf_counter()
    _build.build(["paged_attention", "flash_attention", "fused_adamw",
                  "ring_attention"])
    out = {"build_s": time.perf_counter() - t}
    for name, code in (("import_torch_s", "import torch"),
                       ("cuda_context_s",
                        "import torch; torch.zeros(1, device='cuda')")):
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], check=True)
        out[name] = time.perf_counter() - t
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(args.nproc), os.path.abspath(__file__),
           "train", "--config", args.config, "--sync-steps"]
    for o in args.override or DEFAULT_OVERRIDES:
        cmd += ["--override", o]
    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=ROOT, LAUNCH_PROFILE_T0=str(t0))
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True)
    out["launch_s"] = time.time() - t0
    lines = proc.stdout.splitlines()
    print("\n".join(x for x in lines if x.startswith("rank")))
    end = [json.loads(x) for x in lines if x.startswith('{"event": '
                                                        '"train_end"')]
    out["step_s"] = end[0]["step_s"] if end else None
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    print(json.dumps(out))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
