"""CLI entry points: ``python -m distributeddeeplearning_tpu_torch.cli
{train,supervise,eval,benchmark,generate,serve,launch}``.

``train`` runs the training path (``build_all`` -> ``Trainer`` -> ``fit``)
on one rank, or on every rank ``torchrun`` starts (one process per rank,
``mesh.dp`` x ``mesh.fsdp`` x ``mesh.pp`` x ``mesh.tp`` x ``mesh.cp`` x
``mesh.ep`` of them), resuming from ``train.checkpoint_dir``;
``eval`` evaluates its latest checkpoint; ``benchmark`` times the config's
training step (``benchmark.run_benchmark``: images or tokens per second per
GPU); ``generate`` samples from its latest checkpoint's weights with the
KV-cache decoder (``generate.py``); ``serve`` runs the serving engine on
them — one engine, ``serving.replicas`` engines behind a router in this
process, or ``--fleet N`` worker processes behind a router over sockets,
supervised and restarted when one dies (``serving.prefill_replicas``
splits the fleet into prefill and decode workers); ``launch`` starts
``--num-processes`` ``cli train`` ranks of one job on this machine, as
``torchrun`` would; ``supervise`` runs ``train`` as a child process and
restarts it after a crash, a hang or a corrupt checkpoint, and stops it
with a save on SIGTERM (``supervisor.py``). All run on the GPU by
default; ``--device cpu`` asks for the CPU (and gloo under ``torchrun``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import sys

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


def _refuse_compile_cache(cfg: Config) -> None:
    if cfg.train.compile_cache_dir:
        raise NotImplementedError(
            f"train.compile_cache_dir={cfg.train.compile_cache_dir!r}: the "
            "port has no persistent compile cache (eager torch; the hand "
            "kernels build into ops/_build) — drop the override")


def check_train_composition(cfg: Config, world_size: int = 1) -> None:
    """The reference's composition fences of a training config over a job
    of ``world_size`` ranks, before anything is built: the explicit dp
    sync's, and ``mesh.ep`` over a model without experts (a pipelined
    model's own fence names it, in the Trainer). A compile cache directory
    is refused by name: the port has none."""
    from .comms_hier import check_comm_hierarchy_config
    from .comms_overlap import check_update_sharding_config
    from .train import check_explicit_sync

    _refuse_compile_cache(cfg)
    # The reference's config-time fences of the explicit dp sync (its
    # optimizer-level ones, then the hierarchy's), then its Trainer's,
    # all before the build.
    t = cfg.train
    check_update_sharding_config(
        update_sharding=t.update_sharding, grad_bucket_mb=t.grad_bucket_mb,
        optim_name=cfg.optim.name, weight_decay=cfg.optim.weight_decay,
        grad_clip=cfg.optim.grad_clip)
    check_comm_hierarchy_config(comm_hierarchy=t.comm_hierarchy,
                                dcn_dp=cfg.mesh.dcn_dp)
    sizes = _mesh_sizes(cfg, world_size)
    check_explicit_sync(
        grad_comm=t.grad_comm, grad_bucket_mb=t.grad_bucket_mb,
        update_sharding=t.update_sharding, dcn_dp=cfg.mesh.dcn_dp,
        comm_hierarchy=t.comm_hierarchy,
        pipelined=models.is_pipelined(cfg.model.name), mesh_shape=sizes,
        grad_accum=t.grad_accum, model_name=cfg.model.name)
    ep = sizes["ep"]
    name = cfg.model.name
    if ep > 1 and not (models.has_experts(name) or models.is_pipelined(name)):
        raise ValueError(
            f"mesh ep={ep} but model {name!r} has no experts: the ep axis "
            "would silently replicate — use an MoE model (gpt2_moe/"
            "llama_moe) or drop the axis")


def build_all(cfg: Config, device, mesh=None, fault_nan_step=None):
    """Construct (model, trainer, dataset) from a config on ``device``, for
    this rank of ``mesh`` (default: the one-rank mesh), which the model
    gets too (ResNet syncs its BatchNorm statistics over its dp ranks, the
    ring attention cores rotate over its cp ranks). The model's compute
    dtype follows ``train.precision.policy`` when the policy is mixed, and
    ``train.remat`` other than 'none' sets the model's per-block activation
    checkpointing, as in the reference. The trainer carries the config's
    health guard and ``fault_nan_step`` (the step whose gradients the
    ``nan:K`` fault poisons)."""
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
    if cfg.train.remat != "none":
        if not models.supports_remat(cfg.model.name):
            raise ValueError(
                f"model {cfg.model.name!r} does not support remat")
        kwargs["remat"] = cfg.train.remat
    if cfg.train.sequence_parallel and mesh.shape["tp"] > 1:
        # Megatron sequence parallelism (``parallel.tp.tp_rules``): the
        # activations' seq over tp between the blocks; a no-op at tp = 1.
        kwargs["sequence_parallel"] = True
    model = models.get_model(cfg.model.name, **kwargs, mesh=mesh).to(device)
    if cfg.train.remat != "none" and getattr(model, "remat",
                                             None) != cfg.train.remat:
        raise ValueError(f"model {cfg.model.name!r} does not support remat")
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
        grad_accum=cfg.train.grad_accum, health=cfg.health,
        fault_nan_step=fault_nan_step, grad_comm=cfg.train.grad_comm,
        grad_comm_block=cfg.train.grad_comm_block,
        grad_bucket_mb=cfg.train.grad_bucket_mb,
        update_sharding=cfg.train.update_sharding, dcn_dp=cfg.mesh.dcn_dp,
        comm_hierarchy=cfg.train.comm_hierarchy,
    )
    dataset = data.make_dataset(cfg.data.kind, **cfg.data.dataset_kwargs())
    return model, trainer, dataset


def _rank_report(device, history, state, ckpt, transport=()) -> dict:
    """What one rank reports at the end: its kernel launch counts (and the
    flash kernels' folded [bh, L, D] shapes), its peak device memory, its optimizer state's bytes (Adam's moments, a shard of
    them under ZeRO-1, or SGD's trace), the losses it logged, the norm of
    its error-feedback residual under a compressed sync, its
    checkpoint saves' timings, and what the pipeline schedules did on it
    (``parallel.pp.TICKS``) when they ran; for a model cut over tp, fsdp or
    ep
    its params' bytes (its gradients' are the same) against the whole
    model's fp32 bytes, the sharded fractions, and the seconds inside the
    transport's calls each step (``transport``: ``comms.TRANSPORT``'s
    seconds at the end of each step)."""
    from .ops import flash_attention, fused_adamw, ring_attention_pallas
    from .parallel import pp
    from .train import opt_state_bytes

    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    res = state.grad_residual
    res = (list(res) if isinstance(res, tuple)
           else list(res.values()) if res is not None else [])
    opt_bytes = opt_state_bytes(state.opt_state)
    report = {
        "launches": {**flash_attention.LAUNCHES, **fused_adamw.LAUNCHES,
                     **ring_attention_pallas.LAUNCHES},
        "flash_shapes": {k: sorted(v)
                         for k, v in flash_attention.SHAPES.items()},
        "peak_mem_gb": peak,
        "opt_state_bytes": opt_bytes,
        "losses": [r["loss"] for r in history if "loss" in r],
        "checkpoints": ckpt.timings if ckpt is not None else [],
        **({"grad_residual_norm": float(torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(r) for r in res])))}
           if res else {}),
        **({"pipeline": dict(pp.TICKS)} if pp.TICKS["train_ticks"]
           else {}),
    }
    if state.shards is not None:
        from .parallel.fsdp import sharded_fraction

        report["shards"] = {
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in state.params.values()),
            "whole_param_bytes": 4 * state.shards.whole_numel(state.params),
            "sharded_fraction": {a: sharded_fraction(state.shards, a)
                                 for a in ("tp", "fsdp", "ep")},
            "transport_s_by_step": [
                b - a for a, b in zip([0.0, *transport], transport)],
        }
    return report


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
    report (:func:`_rank_report`), in a final ``train_end`` event record.

    With the health guard on, ``max_consecutive_anomalies`` anomalous steps
    in a row end the attempt (``train.HealthRollback``): training restarts
    from the last checkpoint (a ``rollback_restart`` record), up to
    ``health.max_rollbacks`` times, then gives up with exit code 1 (a
    ``rollback_give_up`` record on stderr). A restart models a transient
    fault, so an injected fault is disarmed for it; so it is in a child of
    ``cli supervise`` past its first attempt (``DDL_SUPERVISOR_ATTEMPT`` >
    0, a ``fault_disarmed`` record). A SIGTERM or SIGINT ends the run with
    a forced save and exit code ``EXIT_PREEMPTED`` (a ``preempted_exit``
    record). ``train.debug_nans`` and ``train.debug_checks`` turn on
    ``debug.nan_checks`` and ``debug.bounds_checks`` for the run;
    ``telemetry.enabled`` writes the Trainer's telemetry bundle (one per
    process, reused across rollbacks)."""
    import os

    from . import debug
    from .mesh import DistEnv
    from .supervisor import ATTEMPT_ENV, EXIT_PREEMPTED
    from .telemetry import Telemetry
    from .train import HealthRollback, Preempted, check_fusion_cadences
    from .train import parse_fault_injection

    t = cfg.train
    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    fault = parse_fault_injection(t.fault_injection)
    attempt = int(os.environ.get(ATTEMPT_ENV, "0") or 0)
    if fault is not None and attempt > 0:
        # One-shot: a supervised restart replays the run without the fault
        # (else step:K would crash-loop and hang:K stall every attempt).
        print(json.dumps({"event": "fault_disarmed", "attempt": attempt,
                          "fault": f"{fault.kind}:{fault.step}"}),
              flush=True)
        fault = None
    # Cadence fences before the build: fit checks again with the resume
    # step.
    check_fusion_cadences(t.steps_per_call, steps=t.steps,
                          log_every=t.log_every, eval_every=t.eval_every,
                          save_every=t.save_every, fault=fault)
    with (_joined(cfg, device) as (device, mesh, say),
          debug.nan_checks(t.debug_nans),
          debug.bounds_checks(t.debug_checks)):
        tel = Telemetry.from_config(
            cfg, attempt=attempt,
            process_index=mesh.rank if mesh.size > 1 else None)
        rollbacks = 0
        while True:
            try:
                _train_once(cfg, device, mesh, say, sync_steps, fault, tel)
                return 0
            except Preempted as p:
                # fit saved already; the exit code tells a supervisor not
                # to restart.
                say(json.dumps({"event": "preempted_exit", "step": p.step,
                                "saved": p.saved}))
                return EXIT_PREEMPTED
            except HealthRollback as rb:
                rollbacks += 1
                if rollbacks > cfg.health.max_rollbacks:
                    if mesh.rank == 0:
                        print(json.dumps({
                            "event": "rollback_give_up",
                            "rollbacks": rollbacks - 1,
                            "max_rollbacks": cfg.health.max_rollbacks,
                            "step": rb.step,
                        }), file=sys.stderr, flush=True)
                    return 1
                say(json.dumps({
                    "event": "rollback_restart", "rollbacks": rollbacks,
                    "step": rb.step, "consecutive": rb.consecutive,
                }))
                fault = None


def _train_once(cfg: Config, device, mesh, say, sync_steps: bool, fault,
                tel) -> None:
    """One attempt of :func:`cmd_train` on this rank of ``mesh``: build,
    resume from the latest checkpoint if any, and fit, with ``fault`` (a
    ``train.FaultSpec`` or None) armed. ``tel`` (a ``telemetry.Telemetry``)
    brackets the attempt: its goodput ledger is opened at the resume step
    and closed, and its trace written, on every exit path."""
    import torch.distributed as dist

    from . import comms, data
    from .checkpoint import CheckpointManager
    from .metrics import MetricWriter, Profiler, event_record
    from .parallel import pp
    from .train import fit

    t = cfg.train
    ckpt = writer = None
    pp.reset_ticks()  # the train_end record reports this attempt's
    try:
        _, trainer, dataset = build_all(
            cfg, device, mesh,
            fault_nan_step=(fault.step if fault is not None
                            and fault.kind == "nan" else None))
        live = {a: n for a, n in mesh.shape.items() if n > 1}
        say(f"devices: {mesh.size}  device: {device}  mesh: {live or {}}")
        state = trainer.init(t.seed)
        start_index = 0
        if t.checkpoint_dir:
            ckpt = CheckpointManager(t.checkpoint_dir)
            if ckpt.latest_step() is not None:
                state, data_state = ckpt.restore(state)
                start_index = int(data_state.get("next_index", state.step))
                say(f"resumed from step {state.step}")
        whole = state.shards or state.stage_rows
        n = (whole.whole_numel(state.params) if whole is not None
             else sum(p.numel() for p in state.params.values()))
        say(f"model: {cfg.model.name}  params: {n:,}")
        placed = data.sharded_batches(dataset.iter_from(start_index), mesh,
                                      t.grad_accum)
        if t.steps_per_call > 1:
            placed = data.stacked_batches(placed, t.steps_per_call)
        batches = data.prefetch(placed, device, size=cfg.data.prefetch_size)
        writer = MetricWriter(t.log_dir)
        if tel.ledger is not None:
            # Opened at the resume step: steps an earlier attempt passed
            # are classed rollback_replay.
            tel.ledger.open(start_index)
        step_s = [] if sync_steps else None
        # The pipeline's, and the transport's, seconds at the end of each
        # step.
        transport, calls_s = [], []
        comms.reset_transport()
        state, history = fit(
            trainer, state, batches, steps=t.steps, log_every=t.log_every,
            steps_per_call=t.steps_per_call,
            log_fn=lambda m: say(json.dumps(m)), writer=writer,
            profiler=Profiler(t.profile_steps, t.log_dir), ckpt=ckpt,
            save_every=t.save_every, fault=fault, eval_every=t.eval_every,
            eval_fn=(make_eval_fn(cfg, mesh, device) if t.eval_every
                     else None),
            step_times=step_s,
            health=cfg.health if cfg.health.enabled else None,
            telemetry=tel,
            on_step=(lambda _: (
                transport.append(pp.TICKS["train_transport_s"]),
                calls_s.append(comms.TRANSPORT["seconds"])))
            if sync_steps else None)
        if ckpt is not None:
            ckpt.wait()
        if sync_steps:
            report = _rank_report(device, history, state, ckpt, calls_s)
            if "pipeline" in report:
                report["pipeline"]["transport_s_by_step"] = [
                    b - a for a, b in zip([0.0] + transport, transport)]
            extra = {k: report[k] for k in ("launches", "peak_mem_gb",
                                            "opt_state_bytes", "checkpoints")}
            if mesh.size > 1:
                extra = {"backend": dist.get_backend(),
                         "ranks": mesh.comm.gather_objects(report)}
            if trainer.explicit:
                from .benchmark import sync_fields

                extra["sync"] = sync_fields(cfg, trainer, state, mesh)
            say(json.dumps(event_record("train_end", t.steps, step_s=step_s,
                                        **extra)))
    finally:
        # An abandoned in-flight save would quietly roll a resume back by
        # save_every steps: drain it on every exit path.
        if ckpt is not None:
            ckpt.close()
        if writer is not None:
            writer.close()
        if tel.ledger is not None:
            tel.ledger.close()
        tel.write_trace()


def cmd_supervise(args) -> int:
    """Run ``cli train`` under the restart supervisor (``supervisor.py``):
    the child is this CLI's ``train`` with the same ``--config`` and
    ``--override`` flags (and ``--device`` where given); restarts, backoff
    and hang detection come from the config's ``supervisor`` section. This
    process touches no device and joins no process group, so it outlives
    any child's crash. With ``telemetry.enabled`` the supervisor adds its
    backoff records to the children's goodput ledger, a flight record of
    each hang or crash kill, and a ``goodput_summary`` record at the end.
    The exit code is the last child's (0 when it finished,
    ``EXIT_PREEMPTED`` after a preemption's save)."""
    import os

    from .supervisor import supervise_command

    if args.xla_perf_flags:
        raise NotImplementedError(
            "cli supervise --xla-perf-flags: an XLA runtime option, which "
            "the port (torch) has no use for")
    cfg = apply_overrides(load_config(args.config), args.override)
    # Here too, not only in the child: a refused child would crash-loop.
    _refuse_compile_cache(cfg)
    cmd = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
           "train", "--config", args.config]
    for o in args.override:
        cmd += ["--override", o]
    if args.device is not None:
        cmd += ["--device", args.device]
    goodput_path = flight_dir = None
    if cfg.telemetry.enabled:
        from .telemetry import resolve_dir, resolve_process_index, stamped

        flight_dir = resolve_dir(cfg)
        os.makedirs(flight_dir, exist_ok=True)
        # Stamped as the child's ledger is, so the backoff records land in
        # the file its attempts append to.
        goodput_path = os.path.join(flight_dir, stamped(
            cfg.telemetry.goodput_file, resolve_process_index()))
    return supervise_command(cmd, cfg.supervisor, goodput_path=goodput_path,
                             flight_dir=flight_dir)


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


def cmd_benchmark(cfg: Config, *, device=None, steps: int = 30,
                  latency_steps=None, probe=None) -> int:
    """Time the config's training step on this rank (every rank under
    ``torchrun``); rank 0 prints the one-line JSON record of
    ``benchmark.run_benchmark`` at the depth given (its defaults unless
    set)."""
    from .benchmark import run_benchmark
    from .mesh import DistEnv

    check_train_composition(cfg, world_size=DistEnv.from_environ().world_size)
    with _joined(cfg, device) as (device, mesh, say):
        say(json.dumps(run_benchmark(cfg, device, mesh, steps=steps,
                                     latency_steps=latency_steps,
                                     fused_probe=probe)))
    return 0


def cmd_generate(cfg: Config, prompts: list[str], max_new_tokens: int,
                 temperature: float, seed: int, *, top_k: int = 0,
                 top_p: float = 0.0, bench: bool = False, reps: int = 3,
                 device=None) -> int:
    """Sample text from the latest checkpoint of ``train.checkpoint_dir``
    (or fresh weights) with the KV-cache decoder (``generate.py``). Byte
    tokenizer: prompts are encoded as UTF-8 bytes, completions decoded
    back. Repeating ``--prompt`` batches uneven prompts (left-padded);
    ``--bench`` times prefill and the per-token decode loop apart
    (``generate.decode_bench``, medians over ``reps`` runs) and adds its
    record. Prints one JSON
    record: the step, the bench fields, the results."""
    import inspect

    import numpy as np

    from .generate import decode_bench, pad_prompts
    from .generate import generate as run_generate
    from .train import TrainState

    # Cheap argument validation before the model build and restore.
    if temperature == 0.0 and (top_k or top_p):
        raise ValueError(
            "--top-k/--top-p only apply when sampling — set --temperature"
        )
    if any(not p for p in prompts):
        raise ValueError("prompt must be non-empty")
    if bench and max_new_tokens < 2:
        raise ValueError(
            "--bench needs --max-new-tokens >= 2 (at least one per-token "
            "decode step to time)"
        )
    if bench and reps < 3:
        raise ValueError("--bench needs --reps >= 3 for a stable median")
    device = resolve_device(device)
    model, _, _ = build_all(cfg, device)
    if "cache" not in inspect.signature(model.forward).parameters:
        raise ValueError(
            f"model {cfg.model.name!r} has no KV-cache decode support"
        )
    # Byte tokenizer only: a BPE model's ids are not bytes, so encoding
    # and decoding would be silently meaningless.
    vocab = getattr(model, "vocab_size", 0)
    if vocab != 256:
        raise ValueError(
            f"cli generate requires a byte-tokenizer model "
            f"(vocab_size=256, got {vocab}): prompts are encoded as UTF-8 "
            "bytes and completions decoded back (prepare_data "
            "--tokenizer byte). Use generate.generate() directly for "
            "other tokenizers."
        )
    model.init_weights(torch.Generator().manual_seed(int(cfg.train.seed)))
    state = _restore_or_init(
        cfg, TrainState(step=0, params=dict(model.named_parameters()),
                        opt_state=None, rng=int(cfg.train.seed),
                        model_state=dict(model.named_buffers())),
        "generating from")
    encoded = [list(p.encode("utf-8")) for p in prompts]
    tokens, lens = pad_prompts(encoded, pad_id=0)
    if tokens.shape[1] + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({tokens.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds model max_len {model.max_len}"
        )
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(max_new_tokens=max_new_tokens, temperature=temperature,
              top_k=top_k, top_p=top_p, generator=gen, prompt_lens=lens)
    record: dict = {"step": state.step}
    if bench:
        out, bench_rec = decode_bench(model, tokens, reps=reps, **kw)
        record.update(bench_rec)
    else:
        out = run_generate(model, tokens, **kw)
    new = out[:, tokens.shape[1]:].cpu().numpy()
    record["results"] = [
        {"prompt": p,
         "completion": bytes(int(t) for t in np.asarray(row)).decode(
             "utf-8", errors="replace")}
        for p, row in zip(prompts, new)
    ]
    print(json.dumps(record))
    return 0


def _result_record(st) -> dict:
    """One finished request as ``serve`` reports it: its metrics, the
    prompt and completion as text (byte vocabulary) and the greedy ids."""
    m = st.metrics()
    m["prompt"] = bytes(st.request.prompt).decode("utf-8", "replace")
    m["completion"] = bytes(
        t for t in st.generated if 0 <= t < 256
    ).decode("utf-8", errors="replace")
    m["generated"] = [int(t) for t in st.generated]
    return m


def cmd_serve(cfg: Config, prompts: list[str], max_new_tokens: int,
              temperature: float, seed: int, *, top_k: int = 0,
              top_p: float = 0.0, device=None) -> int:
    """Serve a batch of prompts through the continuous-batching engine
    (byte tokenizer: prompts are UTF-8 bytes, completions decoded back),
    or with ``serving.replicas > 1`` through that many engine replicas
    behind a ``ReplicaRouter`` (each with its own stamped telemetry bundle
    in the shared dir). Prints one JSON record with completions (and each
    request's token ids), per-request latency metrics, engine (or router)
    stats and the lifecycle event stream."""
    from .serving import Request, ServingEngine, check_serving_composition

    # Composition fences FIRST (fail by name before any build).
    check_serving_composition(cfg)
    if temperature > 0 and cfg.serving.speculation != "off":
        # The engine refuses a sampled request at submit, after the build
        # and the restore: every request here shares one --temperature.
        raise NotImplementedError(
            "cli serve --temperature > 0 x serving.speculation: "
            "speculative serving is greedy-only — drop --temperature or "
            "set serving.speculation=off"
        )
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
    from .telemetry import Telemetry, resolve_dir

    requests = [
        Request(prompt=list(p.encode("utf-8")), max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p)
        for p in prompts
    ]
    tel_extra = {}
    if cfg.serving.replicas > 1:
        # The router tier: N engine replicas behind gauge-driven dispatch.
        # Each replica stamps its own telemetry bundle (process_index=i)
        # into the shared dir, so no top-level bundle is built here (its
        # p0 stamp would collide with replica 0's).
        from .serving import ReplicaRouter

        tdir = resolve_dir(cfg) if cfg.telemetry.enabled else None
        router = ReplicaRouter(model, cfg.serving, seed=seed,
                               telemetry_dir=tdir, device=device)
        router.warmup()
        for req in requests:
            router.submit(req)
        finished = router.run()
        router.write_trace()
        stats, events = router.stats(), router.events
        if tdir:
            tel_extra["telemetry_dir"] = tdir
    else:
        tel = Telemetry.from_config(cfg)
        engine = ServingEngine(model, cfg.serving, seed=seed, device=device,
                               telemetry=tel)
        engine.warmup()
        for req in requests:
            engine.submit(req)
        finished = engine.run()
        tel.write_trace()
        stats, events = engine.stats(), engine.events
        if tel.enabled:
            tel_extra["telemetry"] = tel.registry.to_dict()
            tel_extra["telemetry_dir"] = tel.dir
    results = [_result_record(st) for st in finished]
    record = {
        "step": state.step,
        "results": results,
        "stats": stats,
        "events": events,
        **tel_extra,
    }
    print(json.dumps(record))
    return 0


# The rank env of ``mesh.DistEnv`` (what ``torchrun`` sets).
_RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    import socket

    with socket.socket() as so:
        so.bind(("localhost", 0))
        return so.getsockname()[1]


def _launch_plan(config: str, overrides: list[str], num_processes: int, *,
                 coordinator_port: int = 0, base_env: dict | None = None,
                 independent: bool = False, device: str | None = None,
                 sync_steps: bool = False):
    """``[(cmd, env), ...]`` for every child of ``cli launch`` — pure (no
    process is spawned), so tests can pin the plan.

    Children are plain ``cli train`` runs; the job reaches them through the
    env ``mesh.DistEnv`` reads, as ``torchrun`` sets it (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), so a launched child and one ``torchrun`` starts take
    the same code path. Every child gets ``DDL_PROCESS_INDEX``, its index.
    ``independent=True`` skips the rendezvous: the children run as N
    single-process jobs, the inherited rank env scrubbed. ``device``: the
    children's ``--device`` (default: the card); ``sync_steps``: their
    ``--sync-steps``."""
    import os

    if num_processes < 2:
        raise ValueError(
            f"--num-processes={num_processes}: a multiprocess launch needs "
            ">= 2 (single-process runs don't need the launcher)"
        )
    port = None if independent else (coordinator_port or _free_port())
    cmd = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
           "train", "--config", config]
    for o in overrides:
        cmd += ["--override", o]
    if device is not None:
        cmd += ["--device", device]
    if sync_steps:
        cmd.append("--sync-steps")
    plan = []
    for pid in range(num_processes):
        env = dict(os.environ if base_env is None else base_env)
        if not independent:
            env.update(RANK=str(pid), WORLD_SIZE=str(num_processes),
                       LOCAL_RANK=str(pid),
                       LOCAL_WORLD_SIZE=str(num_processes),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        else:
            # A previous job's rank env must not leak into the children:
            # each is its own single-process job.
            for k in _RANK_ENV:
                env.pop(k, None)
        env["DDL_PROCESS_INDEX"] = str(pid)
        plan.append((list(cmd), env))
    return plan


def _stream_prefixed(stream, prefix: str, out) -> None:
    """Copy ``stream`` to ``out`` line by line with a ``[pK] `` prefix, so
    the interleaved output of N children stays attributable."""
    for line in iter(stream.readline, ""):
        out.write(prefix + line)
        out.flush()
    stream.close()


def _fleet_plan(config: str, overrides: list[str], fleet: int, *,
                host: str = "127.0.0.1", port_base: int = 0,
                telemetry_dir: str | None = None,
                spill_dir: str | None = None,
                worker_args: list[str] | None = None,
                base_env: dict | None = None,
                roles: list[str] | None = None,
                device: str | None = None):
    """``[(cmd, env), ...]`` for every worker of ``cli serve --fleet N``
    — pure (no process is spawned), so tests can pin the plan.

    Workers are ``serving.worker`` runs (one ServingEngine process each)
    with the ``cli launch`` child conventions: every child gets
    ``DDL_PROCESS_INDEX=i`` (the telemetry stamp, so N workers sharing one
    telemetry dir write non-clobbering artifacts) and the rank env of a
    coordinated job is scrubbed — a fleet worker is single-process by
    construction. ``device`` is every worker's ``--device`` (default: the
    card); no worker is pinned to a device of its own.

    ``roles`` (from ``serving.prefill_replicas``) pins worker ``i`` to
    ``serving.role=roles[i]`` via a trailing override — trailing so it
    wins over any user-supplied role — and scrubs the fleet-level
    ``prefill_replicas`` knob (a child validates with ``fleet=1``, and
    the split topology is the PARENT'S concern; the child only needs
    its own phase). Because the plan is per-index, a supervisor respawn
    re-runs plan[i] and the worker rejoins with its original role."""
    import os

    plan = []
    for i in range(fleet):
        cmd = [
            sys.executable, "-m",
            "distributeddeeplearning_tpu_torch.serving.worker",
            "--config", config,
            "--replica-index", str(i),
            "--host", host,
            "--port", str(port_base + i if port_base else 0),
        ]
        for o in overrides:
            cmd += ["--override", o]
        if roles is not None:
            cmd += ["--override", f"serving.role={roles[i]}",
                    "--override", "serving.prefill_replicas=0"]
        if telemetry_dir:
            cmd += ["--telemetry-dir", telemetry_dir]
        if spill_dir:
            # Per-worker KV spill checkpoint file: the fleet supervisor's
            # restart re-warms worker i from exactly the store worker i
            # checkpointed (indices are stable across restarts).
            cmd += ["--spill-store",
                    os.path.join(spill_dir, f"spill_w{i}.json")]
        if device is not None:
            cmd += ["--device", device]
        if worker_args:
            cmd += list(worker_args)
        env = dict(os.environ if base_env is None else base_env)
        for k in _RANK_ENV:
            env.pop(k, None)
        env["DDL_PROCESS_INDEX"] = str(i)
        plan.append((cmd, env))
    return plan


def read_worker_ready(stream, *, echo=None) -> dict:
    """Scan a worker's stdout for its single ``worker_ready`` JSON line
    (passing any other output through ``echo``); raises on EOF."""
    for line in iter(stream.readline, ""):
        try:
            rec = json.loads(line)
        except ValueError:
            rec = None
        if isinstance(rec, dict) and rec.get("event") == "worker_ready":
            return rec
        if echo is not None:
            echo(line)
    raise RuntimeError(
        "fleet worker exited before reporting worker_ready"
    )


def cmd_serve_fleet(args) -> int:
    """``cli serve --fleet N``: spawn N ``serving.worker`` processes, dial
    their sockets, and serve the prompt batch through a ReplicaRouter
    whose replicas are SocketReplica transports — the cross-process
    counterpart of the in-process ``serving.replicas`` path, with the same
    dispatch, shed, drain and quarantine code. The parent is a process
    babysitter and a socket client: it touches no device; the engines and
    the card belong to the workers, each of which takes the parent's
    ``--device``.

    The parent runs a :class:`~.serving.fleet_supervisor.FleetSupervisor`
    control loop: a worker that exits, drops its socket or goes
    heartbeat-silent is classified (``supervisor.py``), its in-flight work
    retried on the survivors under a bumped attempt epoch, and the process
    restarted with exponential backoff (``serving.max_worker_restarts``,
    ``restart_backoff_*``), re-warming its KV spill tier from the
    ``--spill-store`` file it checkpointed. ``serving.prefill_replicas=K``
    splits the fleet into K prefill and N-K decode workers. The exit code
    is the workers' largest."""
    import os
    import subprocess
    import tempfile
    import threading
    import time

    from .serving import (
        Request,
        check_fleet_composition,
        check_serving_composition,
        connect_fleet,
    )
    from .serving.fleet_supervisor import FleetSupervisor
    from .serving.worker import ATTEMPT_ENV
    from .telemetry import resolve_dir

    cfg = apply_overrides(load_config(args.config), args.override)
    # Composition fences FIRST — fail by name before any child spawns.
    # fleet=args.fleet arms the self-healing fences (fault injection is
    # fleet-only; restart knobs must be sane).
    check_serving_composition(cfg, fleet=args.fleet)
    check_fleet_composition(cfg.serving, args.fleet)
    if args.temperature > 0 and cfg.serving.speculation != "off":
        raise NotImplementedError(
            "cli serve --temperature > 0 x serving.speculation: "
            "speculative serving is greedy-only — drop --temperature or "
            "set serving.speculation=off"
        )
    if any(not p for p in args.prompt):
        raise ValueError("prompt must be non-empty")
    tdir = resolve_dir(cfg) if cfg.telemetry.enabled else None
    # The KV re-warm chain needs a durable spill store per worker; only
    # meaningful when the spill tier exists at all.
    spill_dir = None
    if cfg.serving.spill_blocks > 0:
        spill_dir = tdir or tempfile.mkdtemp(prefix="ddl_fleet_spill_")
    # Disaggregated topology: serving.prefill_replicas=K splits the
    # fleet into K prefill + (N-K) decode workers (fenced above: 0 < K
    # < fleet, prefix_cache on). Roles are pinned per plan index, so
    # supervisor respawns preserve the topology.
    pr = int(cfg.serving.prefill_replicas)
    roles = (
        ["prefill"] * pr + ["decode"] * (args.fleet - pr)
        if pr > 0 else None
    )
    plan = _fleet_plan(
        args.config, args.override, args.fleet,
        host=cfg.serving.worker_host,
        port_base=cfg.serving.worker_port,
        telemetry_dir=tdir,
        spill_dir=spill_dir,
        roles=roles,
        device=args.device,
        worker_args=["--seed", str(args.seed)],
    )
    procs = [None] * args.fleet
    threads, endpoints, ready_s = [], [], []

    def _attach_stream(index, p):
        t = threading.Thread(
            target=_stream_prefixed,
            args=(p.stdout, f"[w{index}] ", sys.stdout),
            daemon=True,
        )
        t.start()
        threads.append(t)

    def _spawn_worker(index, attempt):
        """FleetSupervisor spawn hook: (re)launch worker ``index`` as
        restart ``attempt`` (stamped into $DDL_WORKER_ATTEMPT so one-shot
        fault injection never re-fires on the respawned process) and
        block until its ``worker_ready`` line."""
        cmd, env = plan[index]
        env = dict(env)
        env[ATTEMPT_ENV] = str(attempt)
        p = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        procs[index] = p
        ready = read_worker_ready(
            p.stdout,
            echo=lambda line: sys.stdout.write(f"[w{index}] {line}"),
        )
        _attach_stream(index, p)
        return p, ready

    try:
        # Initial boot stays parallel: spawn everyone, then collect the
        # ready lines (the workers' builds and warmups overlap).
        t0 = time.perf_counter()
        for i, (cmd, env) in enumerate(plan):
            env = dict(env)
            env[ATTEMPT_ENV] = "0"
            procs[i] = subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
        for i, p in enumerate(procs):
            ready = read_worker_ready(
                p.stdout,
                echo=lambda line, i=i: sys.stdout.write(f"[w{i}] {line}"),
            )
            endpoints.append((ready["host"], ready["port"]))
            ready_s.append(time.perf_counter() - t0)
            _attach_stream(i, p)
        router = connect_fleet(cfg.serving, endpoints)
        supervisor = FleetSupervisor(
            router, procs, _spawn_worker, cfg.serving,
        )
        t0 = time.perf_counter()
        for p_text in args.prompt:
            router.submit(Request(
                prompt=list(p_text.encode("utf-8")),
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p,
            ))
        finished = supervisor.run()
        serve_s = time.perf_counter() - t0
        stats, events = router.stats(), router.events
        supervisor.shutdown()
    except BaseException:
        # A worker that never came up (a failed build, a crash in its
        # boot) fails the run: stop the others now rather than let them
        # wait for a router that will not dial.
        for p in procs:
            if p is not None and p.poll() is None:
                p.kill()
        raise
    finally:
        for p in procs:  # no worker outlives the parent
            if p is None:
                continue
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
    rcs = [p.wait() for p in procs if p is not None]
    for t in threads:
        t.join(timeout=5)
    sys.stdout.flush()
    results = [_result_record(st) for st in finished]
    record = {
        "fleet": args.fleet,
        "results": results,
        "stats": stats,
        "events": events,
        "supervisor": supervisor.stats(),
        "supervisor_events": supervisor.events,
        "worker_exit_codes": rcs,
        # Seconds from the spawn to each worker's ready line (read in
        # index order), and from the first submit to the last result.
        "worker_ready_s": ready_s,
        "serve_s": serve_s,
    }
    if tdir:
        record["telemetry_dir"] = tdir
    print(json.dumps(record), flush=True)
    return max(rcs) if rcs else 0


def cmd_launch(args) -> int:
    """Spawn ``--num-processes`` ``cli train`` ranks of one job on this
    machine (:func:`_launch_plan`) and stream their output, each line
    prefixed with its process. The launcher touches no device and joins no
    process group. The exit code is the children's maximum."""
    import subprocess
    import threading

    for flag, on in (("--devices-per-process", args.devices_per_process),
                     ("--xla-perf-flags", args.xla_perf_flags)):
        if on:
            raise NotImplementedError(
                f"cli launch {flag}: an XLA runtime option, which the port "
                "(torch.distributed) has no use for")
    plan = _launch_plan(args.config, args.override, args.num_processes,
                        coordinator_port=args.coordinator_port,
                        independent=args.independent, device=args.device,
                        sync_steps=args.sync_steps)
    procs, threads = [], []
    try:
        for pid, (cmd, env) in enumerate(plan):
            p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            t = threading.Thread(target=_stream_prefixed,
                                 args=(p.stdout, f"[p{pid}] ", sys.stdout),
                                 daemon=True)
            t.start()
            procs.append(p)
            threads.append(t)
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:  # no child outlives the launcher
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=5)
    for pid, rc in enumerate(rcs):
        if rc:
            print(f"[launch] process {pid} exited {rc}", file=sys.stderr)
    return max(rcs)


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

    def telemetry(p, what):
        p.add_argument(
            "--telemetry", nargs="?", const="", default=None, metavar="DIR",
            help=f"enable the telemetry bundle ({what}): sugar for "
            "telemetry.enabled=true, with DIR as telemetry.dir when given "
            "(default <train.checkpoint_dir>/telemetry)",
        )

    t = sub.add_parser("train")
    common(t)
    t.add_argument(
        "--sync-steps", action="store_true",
        help="end every step in a device sync and print the step times in "
        "a final train_end record",
    )
    telemetry(t, "spans, the goodput ledger, flight records")
    su = sub.add_parser("supervise")
    common(su)
    telemetry(su, "the children's, plus the supervisor's backoff and kill "
              "records and a goodput summary")
    su.add_argument("--xla-perf-flags", action="store_true",
                    help="XLA only (refused)")
    e = sub.add_parser("eval")
    common(e)
    b = sub.add_parser("benchmark")
    common(b)
    b.add_argument("--steps", type=int, default=30,
                   help="timed steps after the warm-up")
    b.add_argument("--latency-steps", type=int, default=None,
                   help="steps synced one by one for p50/p90 (default "
                   "min(steps, 12))")
    b.add_argument("--probe", type=int, default=None, metavar="K",
                   help="steps per call of the multi-step probe (default "
                   "train.steps_per_call when above 1, else 8; 0 turns it "
                   "off)")

    def sampling(p, what):
        p.add_argument("--prompt", required=True, action="append",
                       help=f"repeatable: a batch of (uneven) prompts {what}")
        p.add_argument("--max-new-tokens", type=int, default=64)
        p.add_argument("--temperature", type=float, default=0.0)
        p.add_argument("--top-k", type=int, default=0)
        p.add_argument("--top-p", type=float, default=0.0)
        p.add_argument("--seed", type=int, default=0)

    la = sub.add_parser("launch")
    common(la)
    la.add_argument("--num-processes", type=int, required=True,
                    help="cli train ranks to spawn (>= 2)")
    la.add_argument("--coordinator-port", type=int, default=0,
                    help="the ranks' MASTER_PORT (0 = pick a free one)")
    la.add_argument("--independent", action="store_true",
                    help="no rendezvous: N single-process train jobs")
    la.add_argument("--sync-steps", action="store_true",
                    help="the ranks' cli train --sync-steps")
    la.add_argument("--devices-per-process", type=int, default=0,
                    help="XLA only (refused)")
    la.add_argument("--xla-perf-flags", action="store_true",
                    help="XLA only (refused)")
    g = sub.add_parser("generate")
    common(g)
    sampling(g, "decodes together, left-padded")
    g.add_argument(
        "--bench", action="store_true",
        help="time prefill and the per-token decode loop apart (>= 3 reps, "
        "medians) and report decode tokens/sec",
    )
    g.add_argument("--reps", type=int, default=3,
                   help="timed runs of each stage under --bench (>= 3)")
    p = sub.add_parser("serve")
    common(p)
    telemetry(p, "spans, histograms, gauges, the programs' registry")
    sampling(p, "decodes by continuous batching over serving.slots lanes")
    p.add_argument(
        "--fleet", type=int, default=0,
        help="serve through N worker processes (serving.worker, one "
        "engine each, on --device) behind a router over sockets, "
        "supervised and restarted on a crash; serving.prefill_replicas=K "
        "makes K of them prefill workers (0 = serve in this process)",
    )
    r = sub.add_parser("report")
    r.add_argument("--dir", required=True, help="a telemetry directory")
    args = parser.parse_args(argv)
    if args.cmd == "report":
        raise NotImplementedError(
            "cli report: the fleet report (telemetry_aggregate.py, "
            "tools/telemetry_report.py) not yet ported to "
            "distributeddeeplearning_tpu_torch (ROADMAP queue A14)")
    if getattr(args, "telemetry", None) is not None:
        # Before the dispatch: supervise and the fleet build their
        # children's command lines from args.override.
        args.override = list(args.override) + ["telemetry.enabled=True"]
        if args.telemetry:
            args.override.append(f"telemetry.dir={args.telemetry}")
    if args.cmd == "supervise":
        # Before any device use: the children own the card.
        return cmd_supervise(args)
    if args.cmd == "launch":
        # Before any device use: the backend and the rendezvous belong to
        # the children.
        return cmd_launch(args)
    if args.cmd == "train":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_train(cfg, device=args.device, sync_steps=args.sync_steps)
    if args.cmd == "eval":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_eval(cfg, device=args.device)
    if args.cmd == "benchmark":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_benchmark(cfg, device=args.device, steps=args.steps,
                             latency_steps=args.latency_steps,
                             probe=args.probe)
    if args.cmd == "generate":
        cfg = apply_overrides(load_config(args.config), args.override)
        return cmd_generate(
            cfg, args.prompt, args.max_new_tokens, args.temperature,
            args.seed, top_k=args.top_k, top_p=args.top_p, bench=args.bench,
            reps=args.reps, device=args.device,
        )
    if args.fleet:
        # Before any device use: the parent is a babysitter and a socket
        # client; the engines (and the card) belong to the workers.
        return cmd_serve_fleet(args)
    cfg = apply_overrides(load_config(args.config), args.override)
    return cmd_serve(
        cfg, args.prompt, args.max_new_tokens, args.temperature, args.seed,
        top_k=args.top_k, top_p=args.top_p, device=args.device,
    )


if __name__ == "__main__":
    raise SystemExit(main())
