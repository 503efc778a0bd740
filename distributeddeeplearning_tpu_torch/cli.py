"""CLI entry points: ``python -m distributeddeeplearning_tpu_torch.cli
{train,serve}``.

``train`` runs the training path (``build_all`` -> ``Trainer`` -> ``fit``)
on one rank, or on every rank ``torchrun`` starts (one process per rank,
``mesh.dp`` x ``mesh.cp`` of them); ``serve`` the in-process serving engine.
Both run on the GPU by default; ``--device cpu`` asks for the CPU (and gloo
under ``torchrun``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from . import models, resolve_device
from .config import Config, apply_overrides, load_config


def _fresh_or_refuse(cfg: Config) -> None:
    """Serving from a checkpoint is not ported: refuse a checkpoint dir that
    holds one rather than quietly serve freshly initialized weights."""
    d = cfg.train.checkpoint_dir
    if d and os.path.isdir(d) and os.listdir(d):
        raise NotImplementedError(
            f"train.checkpoint_dir={d!r} holds a checkpoint: checkpoint "
            "restore not yet ported to distributeddeeplearning_tpu_torch"
        )
    print("no checkpoint found — serving from freshly initialized params")


def build_model(cfg: Config, device):
    """The config's model with weights drawn from ``train.seed``."""
    model = models.get_model(cfg.model.name, **cfg.model.kwargs)
    gen = torch.Generator().manual_seed(int(cfg.train.seed))
    model.init_weights(gen)
    return model.to(device)


def _mesh_sizes(cfg: Config, world_size: int) -> dict[str, int]:
    """The mesh's axis sizes over ``world_size`` ranks; where they do not
    fit the ranks, -1 counts as 1 (``build_mesh`` then says why)."""
    from .mesh import MESH_AXES, axis_sizes

    try:
        return axis_sizes(cfg.mesh, world_size)
    except ValueError:
        return {a: max(getattr(cfg.mesh, a), 1) for a in MESH_AXES}


# Mesh axes whose parallel strategy is not ported: (what, ROADMAP item).
_UNPORTED_AXES = {
    "fsdp": ("fully sharded data parallelism", "A13"),
    "pp": ("pipeline parallelism", "A13"),
    "tp": ("tensor parallelism", "A13"),
    "ep": ("expert parallelism", "A13"),
    "dcn_dp": ("data parallelism across slices over DCN", "A13"),
}


# (knob, value is on, what it is, ROADMAP queue item that ports it)
def _unported_train_knobs(cfg: Config, world_size: int = 1):
    t, mesh = cfg.train, cfg.mesh
    sizes = {**_mesh_sizes(cfg, world_size), "dcn_dp": mesh.dcn_dp}
    attn = cfg.model.kwargs.get("attn_impl")
    mesh_knobs = [
        ("mesh", dataclasses.asdict(mesh) if sizes[a] > 1 else "",
         f"mesh.{a}={sizes[a]} ({what})", item)
        for a, (what, item) in _UNPORTED_AXES.items()
    ]
    return [
        ("train.checkpoint_dir", t.checkpoint_dir, "checkpoints", "A7"),
        ("train.save_every", t.save_every, "checkpoints", "A7"),
        ("train.eval_every", t.eval_every, "evaluation", "A7"),
        ("train.log_dir", t.log_dir, "the metrics writer", "A7"),
        ("train.profile_steps", t.profile_steps, "the profiler", "A7"),
        ("train.grad_accum", t.grad_accum if t.grad_accum > 1 else 0,
         "gradient accumulation", "A6"),
        ("train.steps_per_call", t.steps_per_call if t.steps_per_call > 1
         else 0, "fused multi-step dispatch", "A7"),
        ("health.enabled", cfg.health.enabled, "the health guard", "A9"),
        ("telemetry.enabled", cfg.telemetry.enabled, "telemetry", "A14"),
        ("train.fault_injection", t.fault_injection, "fault injection",
         "A14"),
        ("train.debug_nans", t.debug_nans, "NaN debugging", "A14"),
        ("train.debug_checks", t.debug_checks, "runtime checks", "A14"),
        ("train.grad_comm", t.grad_comm if t.grad_comm != "fp32" else "",
         "compressed gradient sync", "A13"),
        ("train.grad_bucket_mb", t.grad_bucket_mb,
         "bucketed overlapped gradient sync", "A13"),
        ("train.update_sharding", t.update_sharding
         if t.update_sharding == "sharded" else "",
         "sharded weight update", "A13"),
        ("train.sequence_parallel", t.sequence_parallel,
         "sequence parallelism", "A13"),
        ("train.remat", t.remat if t.remat != "none" else "",
         "rematerialization", "A3"),
        *mesh_knobs,
        ("mesh", dataclasses.asdict(mesh)
         if t.zero1 and sizes["dp"] > 1 else "",
         f"train.zero1=True over mesh.dp={sizes['dp']} (ZeRO-1 across "
         "GPUs; train.zero1=false or mesh.dp=1 runs)", "A6"),
        ("model.kwargs.attn_impl", attn if attn in ("ring", "ring_pallas")
         and sizes["cp"] == 1 else "",
         "a ring over one rank, mesh.cp=1 (the ring cores run on mesh.cp > "
         "1; on one rank attn_impl='flash' is the same attention)", "A13"),
    ]


def check_train_composition(cfg: Config, world_size: int = 1) -> None:
    """Refuse by name, before anything is built, every training knob whose
    feature is not ported yet, over a job of ``world_size`` ranks.
    ``train.zero1=True`` passes over dp=1: JAX's ZeRO-1 is a placement of
    the optimizer state over dp, and over one data-parallel rank that
    placement is a no-op."""
    for knob, value, what, item in _unported_train_knobs(cfg, world_size):
        if value:
            raise NotImplementedError(
                f"{knob}={value!r}: {what} not yet ported to "
                f"distributeddeeplearning_tpu_torch (ROADMAP queue {item})"
            )


def build_all(cfg: Config, device, mesh=None):
    """Construct (model, trainer, dataset) from a config on ``device``, for
    this rank of ``mesh`` (default: the one-rank mesh). The model's compute
    dtype follows ``train.precision.policy`` when the policy is mixed, as in
    the reference."""
    from . import data
    from .mesh import single_device_mesh
    from .models.gpt2 import as_torch_dtype
    from .precision import check_precision_composition
    from .train import Trainer, get_task, make_optimizer

    mesh = mesh or single_device_mesh()
    policy = check_precision_composition(cfg.train.precision.policy,
                                         optim_name=cfg.optim.name)
    check_train_composition(cfg, world_size=mesh.size)
    kwargs = dict(cfg.model.kwargs)
    if policy.mixed:
        explicit = kwargs.get("dtype")
        if explicit is not None and (
                as_torch_dtype(explicit) != policy.compute_dtype):
            raise ValueError(
                f"model.kwargs.dtype={explicit!r} conflicts with "
                f"train.precision.policy={policy.name!r} (compute dtype "
                f"{policy.compute_dtype}): drop model.kwargs.dtype — the "
                "policy owns the compute dtype"
            )
        kwargs["dtype"] = policy.compute_dtype
    model = models.get_model(cfg.model.name, **kwargs, mesh=mesh).to(device)
    tx = make_optimizer(
        cfg.optim.name, cfg.optim.lr, momentum=cfg.optim.momentum,
        b1=cfg.optim.b1, b2=cfg.optim.b2,
        weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, schedule=cfg.optim.schedule,
        total_steps=cfg.train.steps, grad_clip=cfg.optim.grad_clip,
        precision=policy,
    )
    trainer = Trainer(
        model, tx,
        get_task(cfg.train.task, mesh=mesh, head_chunk=cfg.train.head_chunk,
                 label_smoothing=cfg.train.label_smoothing),
        device=device, precision=policy, mesh=mesh,
    )
    dataset = data.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return model, trainer, dataset


def _rank_report(device, history) -> dict:
    """What one rank reports at the end: its kernel launch counts, its peak
    device memory and the losses it logged."""
    from .ops import flash_attention, fused_adamw, ring_attention_pallas

    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return {
        "launches": {**flash_attention.LAUNCHES, **fused_adamw.LAUNCHES,
                     **ring_attention_pallas.LAUNCHES},
        "peak_mem_gb": peak,
        "losses": [r["loss"] for r in history],
    }


def cmd_train(cfg: Config, *, device=None, sync_steps: bool = False) -> int:
    """Train on this rank: one JSON record per ``train.log_every`` steps,
    printed by rank 0. Under ``torchrun`` every rank joins the process
    group first, and the mesh spans ``WORLD_SIZE`` ranks. ``sync_steps``
    ends every step in a device sync and prints each step's seconds, with
    every rank's report (:func:`_rank_report`), in a final ``train_end``
    event record."""
    import torch.distributed as dist

    from . import data
    from .comms import psum
    from .mesh import DistEnv, build_mesh, init_distributed, rank_device
    from .metrics import event_record
    from .train import fit

    env = DistEnv.from_environ()
    check_train_composition(cfg, world_size=env.world_size)
    device = resolve_device(device)
    joined = init_distributed(device, env)
    try:
        if joined:
            device = rank_device(device, env)
        mesh = build_mesh(cfg.mesh)
        lead = mesh.rank == 0

        def say(text):
            if lead:
                print(text, flush=True)

        _, trainer, dataset = build_all(cfg, device, mesh)
        live = {a: n for a, n in mesh.shape.items() if n > 1}
        say(f"devices: {mesh.size}  device: {device}  mesh: {live or {}}")
        state = trainer.init(cfg.train.seed)
        n = sum(p.numel() for p in state.params.values())
        say(f"model: {cfg.model.name}  params: {n:,}")
        batches = data.prefetch(
            data.sharded_batches(dataset.iter_from(state.step), mesh),
            device, size=cfg.data.prefetch_size)
        step_s = [] if sync_steps else None
        _, history = fit(trainer, state, batches, steps=cfg.train.steps,
                         log_every=cfg.train.log_every,
                         log_fn=lambda m: say(json.dumps(m)),
                         step_times=step_s)
        if sync_steps:
            report = _rank_report(device, history)
            extra = {"launches": report["launches"],
                     "peak_mem_gb": report["peak_mem_gb"]}
            if mesh.size > 1:
                extra = {"backend": dist.get_backend(),
                         "ranks": mesh.comm.gather_objects(report)}
            say(json.dumps(event_record("train_end", cfg.train.steps,
                                        step_s=step_s, **extra)))
        if joined:  # no rank leaves while another still reads from it
            psum(torch.zeros((), device=device), mesh)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


def cmd_serve(cfg: Config, prompts: list[str], max_new_tokens: int,
              temperature: float, seed: int, *, top_k: int = 0,
              top_p: float = 0.0, device=None) -> int:
    """Serve a batch of prompts through the continuous-batching engine
    (byte tokenizer: prompts are UTF-8 bytes, completions decoded back).
    Prints one JSON record with completions, per-request latency metrics,
    engine stats and the lifecycle event stream."""
    from .serving import Request, ServingEngine, check_serving_composition

    # Composition fences FIRST (fail by name before any build).
    check_serving_composition(cfg)
    if any(not p for p in prompts):
        raise ValueError("prompt must be non-empty")
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "--top-k/--top-p only apply when sampling — set --temperature"
        )
    vocab = cfg.model.kwargs.get("vocab_size", 50257)
    if vocab != 256:
        raise ValueError(
            f"cli serve requires a byte-tokenizer model (vocab_size=256, "
            f"got {vocab}): prompts are encoded as UTF-8 bytes and "
            "completions decoded back. Use serving.ServingEngine directly "
            "for other tokenizers."
        )
    device = resolve_device(device)
    _fresh_or_refuse(cfg)
    model = build_model(cfg, device)
    engine = ServingEngine(model, cfg.serving, seed=seed, device=device)
    engine.warmup()
    for p in prompts:
        engine.submit(Request(
            prompt=list(p.encode("utf-8")), max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
        ))
    finished = engine.run()
    results = []
    for st in finished:
        m = st.metrics()
        m["prompt"] = bytes(st.request.prompt).decode("utf-8", "replace")
        m["completion"] = bytes(
            t for t in st.generated if 0 <= t < 256
        ).decode("utf-8", errors="replace")
        results.append(m)
    record = {
        "step": 0,
        "results": results,
        "stats": engine.stats(),
        "events": engine.events,
    }
    print(json.dumps(record))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="distributeddeeplearning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", required=True, help="path to a config .py")
        p.add_argument(
            "--override", action="append", default=[], metavar="a.b=v",
            help="dotted config override (repeatable)",
        )
        p.add_argument(
            "--device", default=None,
            help="torch device to run on (default: cuda; 'cpu' on request)",
        )

    t = sub.add_parser("train")
    common(t)
    t.add_argument(
        "--sync-steps", action="store_true",
        help="end every step in a device sync and print the step times in "
        "a final train_end record",
    )
    p = sub.add_parser("serve")
    common(p)
    p.add_argument(
        "--telemetry", nargs="?", const="", default=None, metavar="DIR",
        help="enable telemetry (refused: not yet ported)",
    )
    p.add_argument(
        "--prompt", required=True, action="append",
        help="repeatable: prompts decode together by continuous batching "
        "over serving.slots lanes",
    )
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--fleet", type=int, default=0,
        help="cross-process fleet (refused: not yet ported)",
    )
    args = parser.parse_args(argv)
    if args.cmd == "train":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_train(cfg, device=args.device, sync_steps=args.sync_steps)
    if args.telemetry is not None:
        args.override = list(args.override) + ["telemetry.enabled=True"]
        if args.telemetry:
            args.override.append(f"telemetry.dir={args.telemetry}")
    cfg = apply_overrides(load_config(args.config), args.override)
    if args.fleet:
        from .serving import check_serving_composition

        check_serving_composition(cfg, fleet=args.fleet)
    return cmd_serve(
        cfg, args.prompt, args.max_new_tokens, args.temperature, args.seed,
        top_k=args.top_k, top_p=args.top_p, device=args.device,
    )


if __name__ == "__main__":
    raise SystemExit(main())
