#!/usr/bin/env python3
"""Tile shapes of the port's attention kernels, compared on the card.

Builds variants of ``csrc/flash_attention.cu`` and ``csrc/ring_attention.cu``
that differ only in tile constants (``tc::Shape``, ``tc::kWarps``,
``tc::StepShape``), in where Q's (and dO's) fragments live, or in the
softmax's exp2 (the shared ones in ``csrc/tc_mma.cuh``, which each variant
copies beside its source), each into its own library under ``_build/tiles/``
(one ``nvcc`` each, all started together). Then it times every variant, the
variants in turns over two rounds, L2 flushed before each call: the flash
variants' ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` at GPT-2 124M's
training shape (bf16 causal [384, 1024, 64]) and ``flash_dq`` at D = 128
(bf16 causal [192, 1024, 128]), the ring variants' ``ring_step``,
``ring_dq`` and ``ring_dkv`` at its cp=2 visit (bf16 mode 0 [384, 512, 64],
the carries of a diagonal visit before it) and ``ring_dq`` at D = 128
([192, 512, 128]). The paged decode variants of ``csrc/paged_attention.cu``
differ in the columns of a split (``kSplit``) and the keys a thread loads
(``kKeysPerThread``); they are timed at ``chip_smoke.py``'s decode case (bf16 pool, and int8 pool with
bf16 q), at its wide case (64 rows, every cursor at 1023) and at the wide
case's bytes under one kv head. It prints one JSON line per variant:
ptxas's registers and spills of the tensor-core (or paged) kernels, the
times, and the largest error against the plain versions. Needs an NVIDIA
GPU:

    python3 tools/torch_flash_tiles.py
        [--lib flash_attention|ring_attention|paged_attention]
        [--variant NAME ...]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (library, {text in the sources: its replacement}); a variant with
# no substitutions is the shipped source.
VARIANTS = {
    "shipped": ("flash_attention", {}),
    "fwd_1_strip": ("flash_attention",
                    {"kFwdStrips = D == 64 ? 2 : 1": "kFwdStrips = 1"}),
    "8_warps_1_strip": ("flash_attention", {
        "constexpr int kWarps = 4;": "constexpr int kWarps = 8;",
        "kFwdStrips = D == 64 ? 2 : 1": "kFwdStrips = 1"}),
    "dkv_q32": ("flash_attention",
                {"kDkvQ = D == 64 ? 64 : 32": "kDkvQ = 32"}),
    "dkv_q32_kv_smem": ("flash_attention", {
        "kDkvQ = D == 64 ? 64 : 32": "kDkvQ = 32",
        "kDkvRegs = D == 64": "kDkvRegs = false"}),
    "exp2f": ("flash_attention", {
        'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));':
        "y = exp2f(x);"}),
    # dq: one strip a warp with Q and dO in registers (shipped), against
    # two strips and one strip with Q and dO read from shared memory.
    "dq_2_strips_smem": ("flash_attention", {
        "kDqStrips = 1": "kDqStrips = D == 64 ? 2 : 1",
        "kDqRegs = true": "kDqRegs = false"}),
    "dq_1_strip_smem": ("flash_attention",
                        {"kDqRegs = true": "kDqRegs = false"}),
    "ring_shipped": ("ring_attention", {}),
    "ring_step_q_regs": ("ring_attention",
                         {"kQRegs = D != 64": "kQRegs = true"}),
    "ring_step_1_strip_q_regs": ("ring_attention", {
        "kStrips = Shape<D>::kFwdStrips": "kStrips = 1",
        "kQRegs = D != 64": "kQRegs = true"}),
    # ring_dq: one strip a warp with Q and dO read from shared memory
    # (shipped), against two strips, and one strip with them in registers.
    "ring_dq_2_strips_smem": ("ring_attention",
                              {"kDqStrips = 1": "kDqStrips = D == 64 ? 2 : 1"}),
    "ring_dq_regs": ("ring_attention",
                     {"kRingDqRegs = false": "kRingDqRegs = true"}),
    # paged decode: 128-column splits, 4 keys a thread (shipped), against
    # 64-column splits and deeper loads.
    "paged_shipped": ("paged_attention", {}),
    "paged_split64": ("paged_attention",
                      {"kSplit = 128;": "kSplit = 64;"}),
    "paged_8_keys": ("paged_attention",
                     {"kKeysPerThread = 4;": "kKeysPerThread = 8;"}),
    "paged_split64_8_keys": ("paged_attention", {
        "kSplit = 128;": "kSplit = 64;",
        "kKeysPerThread = 4;": "kKeysPerThread = 8;"}),
}
# Symbol fragment of the kernels whose ptxas stats a variant reports.
REPORTED = {"flash_attention": "_tc", "ring_attention": "_tc",
            "paged_attention": "paged_split"}


def build_variants(_build, chip_smoke, names):
    """Each variant's copy of its library's source and the headers it
    includes, in a directory of its own, with every substitution made in
    the one file that holds its text."""
    headers = sorted(f for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cuh"))
    out_dir = os.path.join(_build.BUILD_DIR, "tiles")
    procs = {}
    for name in names:
        lib_name, subs = VARIANTS[name]
        texts = {}
        for fname in [f"{lib_name}.cu", *headers]:
            with open(os.path.join(_build.CSRC_DIR, fname)) as f:
                texts[fname] = f.read()
        for old, new in subs.items():
            where = [f for f, text in texts.items() if old in text]
            if len(where) != 1:
                raise RuntimeError(f"variant {name}: {old!r} in {where}, "
                                   "expected one file")
            texts[where[0]] = texts[where[0]].replace(old, new)
        var_dir = os.path.join(out_dir, name)
        os.makedirs(var_dir, exist_ok=True)
        for fname, text in texts.items():
            with open(os.path.join(var_dir, fname), "w") as f:
                f.write(text)
        cu = os.path.join(var_dir, f"{lib_name}.cu")
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
                chip_smoke.ptxas_stats(log).items()
                if REPORTED[VARIANTS[name][0]] in sym}
        libs[name] = (ctypes.CDLL(so), regs)
    return libs


def flash_calls(torch, chip_smoke, fa):
    """(name -> (call, the plain versions' outputs)) of the flash kernels at
    the training shape, and of flash_dq at D = 128."""

    def at(bh, D):
        case = chip_smoke.flash_case(torch, dtype=torch.bfloat16, bh=bh,
                                     L=1024, D=D, causal=True)
        kw = dict(causal=True, sm_scale=case["sm_scale"],
                  limit=case["limit"], vl=None)
        q, k, v, do = case["q"], case["k"], case["v"], case["do"]
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
        dq_ref, delta = fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref, **kw)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta, **kw)
        return {
            "fwd": (lambda: fa.flash_fwd(q, k, v, **kw)[:1], (o_ref,)),
            "dq": (lambda: fa.flash_dq(q, k, v, o_ref, do, lse_ref, **kw),
                   (dq_ref, delta)),
            "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta, **kw),
                    (dk_ref, dv_ref)),
        }

    out = at(384, 64)
    out["dq_d128"] = at(192, 128)["dq"]
    return out


def ring_calls(torch, chip_smoke, rp):
    """The same for the ring kernels at the cp=2 mode-0 visit, and for
    ring_dq at D = 128."""
    out = {}
    for sfx, bh, D in (("", 384, 64), ("_d128", 192, 128)):
        case = chip_smoke.ring_case(torch, rp, dtype=torch.bfloat16, bh=bh,
                                    L=512, D=D)
        kern = chip_smoke.ring_calls(rp, case, 0)
        plain = chip_smoke.ring_calls(rp, case, 0, plain=True)
        for name in (("ring_dq",) if sfx else
                     ("ring_step", "ring_dq", "ring_dkv")):
            want = plain[name]()
            out[name + sfx] = (kern[name],
                               want if isinstance(want, tuple) else (want,))
    return out


def one_head(torch, case):
    """The same bytes as ``case`` (every page of every row in use, as in
    the wide case) laid out under one kv head: each (row, head) becomes a
    row of its own and each (block, head) a block, so a page's key rows are
    one contiguous run."""
    q, table = case["q"], case["page_table"].long()
    B, H, D = q.shape

    def relaid(x):  # [NB, bs, H, ...] -> [1 + (NB - 1) * H, bs, 1, ...]
        body = x[1:].transpose(1, 2).reshape(-1, x.shape[1], 1, *x.shape[3:])
        return torch.cat([x[:1, :, :1], body])

    heads = torch.arange(H, device=q.device)
    new_table = 1 + (table - 1)[:, None, :] * H + heads[None, :, None]
    out = dict(q=q.reshape(B * H, 1, D), pool_k=relaid(case["pool_k"]),
               pool_v=relaid(case["pool_v"]),
               page_table=new_table.reshape(B * H, -1).to(torch.int32),
               seq_lens=case["seq_lens"].repeat_interleave(H),
               scale_k=None, scale_v=None)
    if case["scale_k"] is not None:
        for k in ("scale_k", "scale_v"):
            out[k] = relaid(case[k][..., None])[..., 0]
    return out


def paged_calls(torch, chip_smoke, pa):
    """The paged decode kernels at chip_smoke.py's decode case and its wide
    case, bf16 pool and int8 pool under a bf16 q; and the wide case's bytes
    laid out with one kv head (768 rows), where a page's key rows are one
    contiguous run."""
    out = {}
    for name, pool in (("bf16", torch.bfloat16), ("int8_bf16q", torch.int8)):
        for wide in (False, True):
            case = chip_smoke.decode_case(torch, pool=pool,
                                          q_dtype=torch.bfloat16, num_rep=1,
                                          wide=wide)
            args = {k: v for k, v in case.items() if k != "num_rep"}
            layouts = {"": args} if not wide else {
                "_wide": args, "_wide_1head": one_head(torch, args)}
            for sfx, lay in layouts.items():
                out[name + sfx] = (
                    functools.partial(pa.paged_attention, **lay),
                    (pa.paged_attention_plain(**lay),))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", choices=("flash_attention", "ring_attention",
                                      "paged_attention"),
                    help="build and time only this library's variants")
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS),
                    help="build and time only these variants (repeatable)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_tiles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import paged_attention as pa
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas as rp

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    names = [n for n, (lib, _) in VARIANTS.items()
             if args.lib in (None, lib)
             and (not args.variant or n in args.variant)]
    libs = build_variants(_build, chip_smoke, names)
    calls = {}
    if any(VARIANTS[n][0] == "flash_attention" for n in names):
        calls["flash_attention"] = flash_calls(torch, chip_smoke, fa)
    if any(VARIANTS[n][0] == "ring_attention" for n in names):
        calls["ring_attention"] = ring_calls(torch, chip_smoke, rp)
    if any(VARIANTS[n][0] == "paged_attention" for n in names):
        calls["paged_attention"] = paged_calls(torch, chip_smoke, pa)
    times = {name: {} for name in names}
    errs = {}
    for _ in range(2):
        for name in names:
            lib_name = VARIANTS[name][0]
            _build._LIBS[lib_name] = libs[name][0]
            for kname, (call, refs) in calls[lib_name].items():
                got = call()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                errs[name] = max([errs.get(name, 0.0)] + [
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, refs)])
                times[name].setdefault(f"{kname}_ms", []).append(
                    chip_smoke.time_ms(torch, call, iters=20))
    for lib_name in calls:
        _build._LIBS.pop(lib_name, None)
    for name in names:
        print(json.dumps({"variant": name, **times[name],
                          "max_abs_err": errs[name],
                          "ptxas": libs[name][1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
