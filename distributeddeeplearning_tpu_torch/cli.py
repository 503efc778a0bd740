"""CLI entry points: ``python -m distributeddeeplearning_tpu_torch.cli
{train,eval,benchmark,serve}``.

``train`` runs the training path (``build_all`` -> ``Trainer`` -> ``fit``)
on one rank, or on every rank ``torchrun`` starts (one process per rank,
``mesh.dp`` x ``mesh.cp`` of them), resuming from ``train.checkpoint_dir``;
``eval`` evaluates its latest checkpoint; ``benchmark`` times the config's
training step (``benchmark.run_benchmark``: images or tokens per second per
GPU); ``serve`` runs the in-process serving engine on its latest
checkpoint's weights. All run on the GPU by default; ``--device cpu`` asks
for the CPU (and gloo under ``torchrun``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json

import torch

from . import models, resolve_device
from .config import Config, apply_overrides, load_config


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
        ("train.zero1", t.zero1 and cfg.optim.name == "sgd"
         and sizes["dp"] > 1,
         "ZeRO-1 of the SGD momentum trace (optim.name='sgd'; the port "
         "shards AdamW's moments)", "A8"),
        *mesh_knobs,
        ("model.kwargs.attn_impl", attn if attn in ("ring", "ring_pallas")
         and sizes["cp"] == 1 else "",
         "a ring over one rank, mesh.cp=1 (the ring cores run on mesh.cp > "
         "1; on one rank attn_impl='flash' is the same attention)", "A13"),
    ]


def check_train_composition(cfg: Config, world_size: int = 1) -> None:
    """Refuse by name, before anything is built, every training knob whose
    feature is not ported yet, over a job of ``world_size`` ranks."""
    for knob, value, what, item in _unported_train_knobs(cfg, world_size):
        if value:
            raise NotImplementedError(
                f"{knob}={value!r}: {what} not yet ported to "
                f"distributeddeeplearning_tpu_torch (ROADMAP queue {item})"
            )


def build_all(cfg: Config, device, mesh=None):
    """Construct (model, trainer, dataset) from a config on ``device``, for
    this rank of ``mesh`` (default: the one-rank mesh), which the model
    gets too (ResNet syncs its BatchNorm statistics over its dp ranks, the
    ring attention cores rotate over its cp ranks). The model's compute
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
        device=device, precision=policy, mesh=mesh, zero1=cfg.train.zero1,
        grad_accum=cfg.train.grad_accum,
    )
    dataset = data.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return model, trainer, dataset


def _rank_report(device, history, state, ckpt) -> dict:
    """What one rank reports at the end: its kernel launch counts, its peak
    device memory, its optimizer state's bytes (Adam's moments, a shard of
    them under ZeRO-1, or SGD's trace), the losses it logged and its
    checkpoint saves' timings."""
    from .ops import flash_attention, fused_adamw, ring_attention_pallas
    from .train import opt_state_bytes

    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    opt_bytes = opt_state_bytes(state.opt_state)
    return {
        "launches": {**flash_attention.LAUNCHES, **fused_adamw.LAUNCHES,
                     **ring_attention_pallas.LAUNCHES},
        "peak_mem_gb": peak,
        "opt_state_bytes": opt_bytes,
        "losses": [r["loss"] for r in history if "loss" in r],
        "checkpoints": ckpt.timings if ckpt is not None else [],
    }


@contextlib.contextmanager
def _joined(cfg: Config, device):
    """This rank's (device, mesh, say) for the length of a command: under
    ``torchrun`` the rank joins the process group first and leaves it at
    the end, after every rank is done reading from the others. ``say``
    prints on rank 0 only."""
    import torch.distributed as dist

    from .comms import psum
    from .mesh import DistEnv, build_mesh, init_distributed, rank_device

    env = DistEnv.from_environ()
    device = resolve_device(device)
    joined = init_distributed(device, env)
    try:
        if joined:
            device = rank_device(device, env)
        mesh = build_mesh(cfg.mesh)

        def say(text):
            if mesh.rank == 0:
                print(text, flush=True)

        yield device, mesh, say
        if joined:  # no rank leaves while another still reads from it
            psum(torch.zeros((), device=device), mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def make_eval_fn(cfg: Config, mesh, device, dataset=None):
    """A callable returning a fresh iterable of this rank's eval-split
    batches on ``device`` (``train.eval_batches`` of them, from index 0):
    what ``fit(eval_fn=...)`` and :func:`cmd_eval` consume. ``dataset``
    reuses an eval dataset already built."""
    from . import data

    eval_ds = dataset if dataset is not None else data.make_dataset(
        cfg.data.kind, **cfg.data.eval_dataset_kwargs())

    def eval_batches():
        it = itertools.islice(eval_ds.iter_from(0), cfg.train.eval_batches)
        return data.prefetch(data.sharded_batches(it, mesh), device,
                             size=cfg.data.prefetch_size)

    return eval_batches


def _restore_or_init(cfg: Config, state, verb: str, say=print):
    """``state`` restored from the latest checkpoint of
    ``train.checkpoint_dir`` when it holds one, else as it is (freshly
    initialized): the preamble of ``eval`` and ``serve``."""
    from .checkpoint import CheckpointManager

    if cfg.train.checkpoint_dir:
        with CheckpointManager(cfg.train.checkpoint_dir) as ckpt:
            if ckpt.latest_step() is not None:
                state, _ = ckpt.restore(state)
                say(f"{verb} checkpoint at step {state.step}")
                return state
    say(f"no checkpoint found — {verb} freshly initialized params")
    return state


def cmd_train(cfg: Config, *, device=None, sync_steps: bool = False) -> int:
    """Train on this rank: one JSON record per ``train.log_every`` steps
    (and per evaluation), printed by rank 0 and appended to
    ``<train.log_dir>/metrics.jsonl``. Under ``torchrun`` every rank joins
    the process group first, and the mesh spans ``WORLD_SIZE`` ranks. With
    ``train.checkpoint_dir`` holding a checkpoint, training resumes from its
    latest step and batch index (``resumed from step N``); checkpoints are
    saved every ``train.save_every`` steps, and every save is on disk before
    the command returns, on every exit path. ``sync_steps`` ends every step
    in a device sync and prints each step's seconds, with every rank's
    report (:func:`_rank_report`), in a final ``train_end`` event
    record."""
    import torch.distributed as dist

    from . import data
    from .checkpoint import CheckpointManager
    from .mesh import DistEnv
    from .metrics import MetricWriter, Profiler, event_record
    from .train import check_fusion_cadences, fit

    t = cfg.train
    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    # Cadence fences before the build: fit checks again with the resume
    # step.
    check_fusion_cadences(t.steps_per_call, steps=t.steps,
                          log_every=t.log_every, eval_every=t.eval_every,
                          save_every=t.save_every)
    ckpt = writer = None
    try:
        with _joined(cfg, device) as (device, mesh, say):
            _, trainer, dataset = build_all(cfg, device, mesh)
            live = {a: n for a, n in mesh.shape.items() if n > 1}
            say(f"devices: {mesh.size}  device: {device}  mesh: {live or {}}")
            state = trainer.init(t.seed)
            start_index = 0
            if t.checkpoint_dir:
                ckpt = CheckpointManager(t.checkpoint_dir)
                if ckpt.latest_step() is not None:
                    state, data_state = ckpt.restore(state)
                    start_index = int(data_state.get("next_index",
                                                     state.step))
                    say(f"resumed from step {state.step}")
            n = sum(p.numel() for p in state.params.values())
            say(f"model: {cfg.model.name}  params: {n:,}")
            placed = data.sharded_batches(dataset.iter_from(start_index),
                                          mesh, t.grad_accum)
            if t.steps_per_call > 1:
                placed = data.stacked_batches(placed, t.steps_per_call)
            batches = data.prefetch(placed, device,
                                    size=cfg.data.prefetch_size)
            writer = MetricWriter(t.log_dir)
            step_s = [] if sync_steps else None
            state, history = fit(
                trainer, state, batches, steps=t.steps,
                log_every=t.log_every, steps_per_call=t.steps_per_call,
                log_fn=lambda m: say(json.dumps(m)), writer=writer,
                profiler=Profiler(t.profile_steps, t.log_dir), ckpt=ckpt,
                save_every=t.save_every, eval_every=t.eval_every,
                eval_fn=(make_eval_fn(cfg, mesh, device) if t.eval_every
                         else None),
                step_times=step_s)
            if ckpt is not None:
                ckpt.wait()
            if sync_steps:
                report = _rank_report(device, history, state, ckpt)
                extra = {k: report[k] for k in ("launches", "peak_mem_gb",
                                                "opt_state_bytes",
                                                "checkpoints")}
                if mesh.size > 1:
                    extra = {"backend": dist.get_backend(),
                             "ranks": mesh.comm.gather_objects(report)}
                say(json.dumps(event_record("train_end", t.steps,
                                            step_s=step_s, **extra)))
    finally:
        # An abandoned in-flight save would quietly roll a resume back by
        # save_every steps: drain it on every exit path.
        if ckpt is not None:
            ckpt.close()
        if writer is not None:
            writer.close()
    return 0


def cmd_eval(cfg: Config, *, device=None) -> int:
    """Evaluate the latest checkpoint of ``train.checkpoint_dir`` (or fresh
    weights when it holds none) over ``train.eval_batches`` eval batches;
    rank 0 prints one JSON record of the mean ``eval_*`` metrics and the
    step."""
    from .train import evaluate

    with _joined(cfg, device) as (device, mesh, say):
        _, trainer, _ = build_all(cfg, device, mesh)
        state = _restore_or_init(cfg, trainer.init(cfg.train.seed),
                                 "evaluating", say)
        metrics = evaluate(trainer, state, make_eval_fn(cfg, mesh, device)())
        say(json.dumps({**metrics, "step": state.step}))
    return 0


def cmd_benchmark(cfg: Config, *, device=None) -> int:
    """Time the config's training step on this rank (every rank under
    ``torchrun``); rank 0 prints the one-line JSON record of
    ``benchmark.run_benchmark``."""
    from .benchmark import run_benchmark
    from .mesh import DistEnv

    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    with _joined(cfg, device) as (device, mesh, say):
        say(json.dumps(run_benchmark(cfg, device, mesh)))
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
    from .train import TrainState

    device = resolve_device(device)
    model = build_model(cfg, device)
    state = _restore_or_init(
        cfg, TrainState(step=0, params=dict(model.named_parameters()),
                        opt_state=None, rng=int(cfg.train.seed)),
        "serving from")
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
        "step": state.step,
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
    e = sub.add_parser("eval")
    common(e)
    b = sub.add_parser("benchmark")
    common(b)
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
    if args.cmd == "eval":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_eval(cfg, device=args.device)
    if args.cmd == "benchmark":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_benchmark(cfg, device=args.device)
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
