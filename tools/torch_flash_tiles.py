#!/usr/bin/env python3
"""Tile shapes of the bf16 tensor-core flash kernels, compared on the card.

Builds variants of ``csrc/flash_attention.cu`` that differ only in the
constants of ``tc::Shape`` and ``tc::kWarps`` or in the softmax's exp2, each
into its own library under ``_build/tiles/`` (one ``nvcc`` each, all started
together), then times ``flash_fwd`` and ``flash_dkv`` of every variant at
GPT-2 124M's training shape (bf16 causal [384, 1024, 64], L2 flushed before
each call), the variants in turns over two rounds, and prints one JSON line
per variant: ptxas's registers and spills of the bf16 kernels, the times,
and the largest error against the plain versions. Needs an NVIDIA GPU:

    python3 tools/torch_flash_tiles.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> {text in the source: its replacement}; "shipped" is the source.
VARIANTS = {
    "shipped": {},
    "fwd_1_strip": {"kFwdStrips = D == 64 ? 2 : 1": "kFwdStrips = 1"},
    "8_warps_1_strip": {"constexpr int kWarps = 4;": "constexpr int kWarps = 8;",
                        "kFwdStrips = D == 64 ? 2 : 1": "kFwdStrips = 1"},
    "dkv_q32": {"kDkvQ = D == 64 ? 64 : 32": "kDkvQ = 32"},
    "dkv_q32_kv_smem": {"kDkvQ = D == 64 ? 64 : 32": "kDkvQ = 32",
                        "kDkvRegs = D == 64": "kDkvRegs = false"},
    "exp2f": {'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
              "y = exp2f(x);"},
}


def build_variants(_build, chip_smoke):
    src_path = os.path.join(_build.CSRC_DIR, "flash_attention.cu")
    with open(src_path) as f:
        src = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc exited "
                               f"{proc.returncode}\n{log}")
        regs = {sym: stats for sym, stats in
                chip_smoke.ptxas_stats(log).items() if "_tc" in sym}
        libs[name] = (ctypes.CDLL(so), regs)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    libs = build_variants(_build, chip_smoke)
    case = chip_smoke.flash_case(torch, dtype=torch.bfloat16, bh=384, L=1024,
                                 D=64, causal=True)
    kw = dict(causal=True, sm_scale=case["sm_scale"], limit=case["limit"],
              vl=None)
    q, k, v, do = case["q"], case["k"], case["v"], case["do"]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    _, delta = fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
    times = {name: {"fwd_ms": [], "dkv_ms": []} for name in libs}
    errs = {}
    for _ in range(2):
        for name, (lib, _) in libs.items():
            _build._LIBS["flash_attention"] = lib
            o, _ = fa.flash_fwd(q, k, v, **kw)
            dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw)
            torch.cuda.synchronize()
            errs[name] = max((a.float() - b.float()).abs().max().item()
                             for a, b in ((o, o_ref), (dk, dk_ref),
                                          (dv, dv_ref)))
            times[name]["fwd_ms"].append(chip_smoke.time_ms(
                torch, lambda: fa.flash_fwd(q, k, v, **kw), iters=20))
            times[name]["dkv_ms"].append(chip_smoke.time_ms(
                torch, lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta,
                                            **kw), iters=20))
    _build._LIBS.pop("flash_attention", None)
    for name, (_, regs) in libs.items():
        print(json.dumps({"variant": name, **times[name],
                          "max_abs_err": errs[name], "ptxas": regs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
