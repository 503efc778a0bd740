"""Benchmark harness of the port: the counterpart of the JAX package's
``benchmark.py``. It measures the north-star metric (``BASELINE.json:2``:
"ResNet-50 ImageNet images/sec/chip") and the same record for any config
the trainer runs (tokens per second per GPU for the LMs).

Method: ``max(2, n_distinct)`` batches are drawn and staged on the device
before any timing, so the host's data generation is not measured (the
input path has its own numbers: ``cli train --sync-steps``). ``warmup``
steps absorb cuDNN's and cuBLAS's autotuning; then ``steps`` timed steps,
the window bounded by ``torch.cuda.synchronize()`` and a scalar read of the
last loss; throughput = global items x steps / elapsed / world size. Then a
window of ``latency_steps`` steps, each synchronised on its own (p50, p90),
and the multi-step probe: ``Trainer.fused_train_step`` over stacked
superbatches of K steps. The port's fused step dispatches K plain steps
with no host read between them (ROADMAP A15.h), so
``dispatch_overhead_ms_per_step`` reads near zero until it is captured
whole.

FLOPs: one more step under ``torch.utils.flop_counter.FlopCounterMode``
counts the step's matrix products and convolutions (forward and backward,
this rank's share), from which ``achieved_tflops_per_sec`` and ``mfu``
against the card's own dense bf16 peak, looked up by
``torch.cuda.get_device_name()``; an unknown card gets no ``mfu``. Under
pipeline parallelism each rank counts its own stage's FLOPs, under tp its
slice of the heads, MLP units and vocabulary, under fsdp its own rows,
under ep its own experts, under cp its block of the sequence (under
Ulysses, attention over the whole sequence for its ``H / (tp * cp)``
heads; under the ring, its queries against every block): the counts sum
over the ``pp``, ``tp``, ``fsdp``, ``ep`` and ``cp`` groups into
``model_tflops_per_step`` (those ranks' step), and the per-GPU rate is
that over the ``pp`` x ``tp`` x ``fsdp`` x ``ep`` x ``cp`` ranks. They are
model FLOPs: work a group's ranks repeat is counted once
(:func:`model_share`: under ep, everything outside the routed MLPs; under
tp, a routed MLP's router and one-hot products, ViT's patch embedding and
ResNet's convolutions; under cp, a routed MLP's experts, which run over
the whole rows' slots on every cp rank). An MoE model's dense
dispatch and combine einsums multiply one-hots; they are counted like any
product, and ``onehot_tflops_per_step`` with its share of the count says
how much of the MFU they are (``models.moe.onehot_flops``).

Left out of the JAX record: ``vs_baseline`` (``BENCH_BASELINE.json`` holds
TPU numbers, no baseline of this card), the XLA compile and memory
analyses, and the gradient-communication, hierarchy and DCN fields of the
knobs ``cli`` refuses. Under ``torchrun`` every rank runs the benchmark and
``cli benchmark`` prints rank 0's record.
"""

from __future__ import annotations

import time

import torch

from . import data as data_lib
from .config import Config
from .models.moe import MoeMlp, moe_mlps, onehot_flops, router_flops

# Dense bf16 tensor-core peak in TFLOP/s, by a fragment of the card's name
# (NVIDIA's data sheets, at each part's full power limit); first match.
_PEAK_TFLOPS = (
    ("H100 NVL", 835.0),
    ("H100 PCIe", 756.0),
    ("H100", 989.0),
    ("H200", 989.0),
    ("A100", 312.0),
)


def peak_tflops(device) -> float | None:
    """The card's dense bf16 peak, or None (the CPU, an unknown card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((p for key, p in _PEAK_TFLOPS if key in name), None)


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an already sorted list."""
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_share(counts: dict, model, mesh, rows: int = 0, tokens: int = 0,
                forwards: int = 1) -> float:
    """This rank's share of the step's model FLOPs, from a
    ``FlopCounterMode``'s per-module ``counts``: the work a rank repeats
    with the other ranks of a group divided by the group's size, so the
    sum over the groups counts it once. Over ep every rank runs the same
    rows through everything outside the routed MLPs, whose experts and
    router columns it holds a slice of; every rank of an image model runs
    the submodules its ``tp_repeated`` names whole over tp (ViT's patch
    embedding, ResNet's convolutions), and every cp rank the submodules
    its ``cp_repeated`` names (ViT's head, on the CLS token every cp rank
    reads). A routed MLP's router and one-hot products, which every tp
    rank runs whole, are computed from the shapes
    (this rank's ``rows`` x ``tokens`` a step, ``forwards`` under remat:
    ``models.moe.router_flops``, ``onehot_flops``), since the counter files
    the experts' backward under the combine's module; its experts run over
    the whole rows' capacity on every cp rank. The rest of a cp rank's work
    (its block's products, its heads' or its queries' attention) is its
    own."""
    def flops(key):
        return float(sum(counts.get(key, {}).values()))

    total = flops("Global")
    root = type(model).__name__
    tp, ep, cp = (mesh.shape[a] for a in ("tp", "ep", "cp"))
    repeated = sum(flops(f"{root}.{n}")
                   for n in getattr(model, "tp_repeated", ()))
    total = total - repeated + repeated / tp
    repeated = sum(flops(f"{root}.{n}")
                   for n in getattr(model, "cp_repeated", ()))
    total = total - repeated + repeated / cp
    routed = {f"{root}.{n}": m for n, m in model.named_modules()
              if isinstance(m, MoeMlp)}
    moe = sum(flops(k) for k in routed)
    whole = sum(router_flops(m, rows, tokens, forwards, mesh)
                + onehot_flops(m, rows, tokens, forwards, mesh)
                for m in routed.values())
    return (total - moe) / ep + (moe - whole) / cp + whole / tp


def _items(batch: dict) -> tuple[int, str]:
    """(items a global batch holds, unit): images for the vision tasks,
    trained tokens for the LM (whose batches carry seq_len + 1 tokens) and
    the MLM (``input_tokens``, pad positions included, as the
    reference counts them)."""
    if "image" in batch:
        return batch["image"].shape[0], "images/sec/chip"
    if "input_tokens" in batch:
        return batch["input_tokens"].size, "tokens/sec/chip"
    tokens = batch["tokens"]
    return tokens.shape[0] * (tokens.shape[1] - 1), "tokens/sec/chip"


def run_benchmark(cfg: Config, device, mesh=None, *, warmup: int = 5,
                  steps: int = 30, latency_steps: int | None = None,
                  fused_probe: int | None = None) -> dict:
    """Time ``steps`` training steps of the config's workload on this rank
    of ``mesh`` (default one rank) and return the one-line JSON record.

    ``latency_steps`` (default ``min(steps, 12)``) steps each end in a
    device sync: ``p50_step_ms``/``p90_step_ms``. ``fused_probe`` K
    (default ``train.steps_per_call`` when above 1, else 8; 0 or 1 turns
    it off) times ``max(2, steps // K)`` multi-step calls."""
    from .cli import build_all
    from .mesh import single_device_mesh
    from .train import opt_state_bytes

    device = torch.device(device)
    mesh = mesh or single_device_mesh()
    _, trainer, dataset = build_all(cfg, device, mesh)
    state = trainer.init(cfg.train.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    accum = cfg.train.grad_accum

    # Device-resident input: a few distinct batches staged before timing.
    n_staged = max(2, getattr(dataset, "n_distinct", 2))
    it = data_lib.sharded_batches(dataset.iter_from(0), mesh, accum)
    staged = [data_lib.to_device(next(it), device) for _ in range(n_staged)]
    _sync(device)

    step = trainer.train_step
    metrics = None
    for i in range(warmup):
        state, metrics = step(state, staged[i % n_staged])
    _sync(device)
    if metrics is not None:
        float(metrics["loss"])

    t0 = time.perf_counter()
    for i in range(steps):
        state, metrics = step(state, staged[i % n_staged])
    _sync(device)
    loss = float(metrics["loss"])
    elapsed = time.perf_counter() - t0

    items, unit = _items(dataset.batch(0))
    world = mesh.size
    record = {
        "metric": f"{cfg.model.name}_{cfg.train.task}_throughput",
        "value": round(items * steps / elapsed / world, 2),
        "unit": unit,
        "steps_per_sec": round(steps / elapsed, 4),
        "params": sum(p.numel() for p in state.params.values()),
        "device_count": world,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        "loss": loss,
    }

    if latency_steps is None:
        latency_steps = min(steps, 12)
    if latency_steps:
        lats = []
        for i in range(latency_steps):
            t = time.perf_counter()
            state, metrics = step(state, staged[i % n_staged])
            _sync(device)
            lats.append(time.perf_counter() - t)
        lats.sort()
        record["p50_step_ms"] = round(_percentile(lats, 0.5) * 1e3, 3)
        record["p90_step_ms"] = round(_percentile(lats, 0.9) * 1e3, 3)

    # The peak of the training steps, before the probe stages its
    # superbatches.
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else None)
    if fused_probe is None:
        fused_probe = (cfg.train.steps_per_call
                       if cfg.train.steps_per_call > 1 else 8)
    if fused_probe > 1:
        super_it = data_lib.stacked_batches(data_lib.sharded_batches(
            dataset.iter_from(0), mesh, accum), fused_probe)
        supers = [data_lib.to_device(next(super_it), device)
                  for _ in range(2)]
        del super_it
        fstep = trainer.fused_train_step(fused_probe)
        state, fmetrics = fstep(state, supers[0])  # warm
        _sync(device)
        float(fmetrics["loss"][-1])
        n_calls = max(2, steps // fused_probe)
        t0 = time.perf_counter()
        for i in range(n_calls):
            state, fmetrics = fstep(state, supers[i % 2])
        _sync(device)
        float(fmetrics["loss"][-1])
        fused_sps = n_calls * fused_probe / (time.perf_counter() - t0)
        del supers
        record["steps_per_call_probe"] = fused_probe
        record["fused_steps_per_sec"] = round(fused_sps, 4)
        # Signed: a negative value means the multi-step call lost.
        record["dispatch_overhead_ms_per_step"] = round(
            (elapsed / steps - 1.0 / fused_sps) * 1e3, 3)

    record["precision"] = trainer.precision.name
    record["param_bytes_per_member"] = sum(
        p.numel() * p.element_size() for p in state.params.values())
    record["opt_state_bytes_per_member"] = opt_state_bytes(state.opt_state)
    record["hbm_peak_bytes"] = peak_bytes

    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, staged[0])
    _sync(device)
    tokens = staged[0].get("tokens")
    flops = model_share(
        counter.get_flop_counts(), trainer.model, mesh,
        rows=0 if tokens is None else tokens.shape[0],
        tokens=cfg.data.seq_len // mesh.shape["cp"],
        forwards=2 if cfg.train.remat != "none" else 1)
    group = [a for a in ("pp", "tp", "fsdp", "ep", "cp")
             if mesh.shape[a] > 1]
    ranks = 1
    for axis in group:
        from .comms import psum

        flops = float(psum(torch.tensor(flops, dtype=torch.float64,
                                        device=device), mesh, axis))
        ranks *= mesh.shape[axis]
    whole = state.shards or state.stage_rows
    if whole is not None:
        record["params"] = whole.whole_numel(state.params)
    if flops > 0:
        achieved = flops * steps / elapsed / 1e12 / ranks
        record["model_tflops_per_step"] = flops / 1e12
        record["achieved_tflops_per_sec"] = round(achieved, 3)
        peak = peak_tflops(device)
        if peak:
            record["mfu"] = round(achieved / peak, 4)
    mlps = moe_mlps(trainer.model)
    if mlps and flops > 0:
        # Counted above as any product is, as the reference's cost model
        # counts the dense einsums: the share of the MFU that multiplies
        # one-hots.
        # The rows of the ranks the count sums over.
        rows = staged[0]["tokens"].shape[0] * mesh.shape["fsdp"]
        onehot = sum(onehot_flops(m, rows, cfg.data.seq_len,
                                  2 if cfg.train.remat != "none" else 1)
                     for m in mlps)
        record["onehot_tflops_per_step"] = onehot / 1e12
        record["onehot_share_of_counted_flops"] = round(onehot / flops, 4)
    return record
